"""Real-data ingestion: shapefiles + GeoTIFF → Scene.

Follows the reference's data conventions exactly (SURVEY.md §2.1 #2/#3):

  * ``<scene>.tif`` — the raster (``MyUtils1.py:248-252``)
  * ``<scene>.shp`` — polygon layer with the 15 designed-feature fields
    (``MyUtils1.py:79-114``) and a ``PointID`` space-separated sample-point
    mapping (``MyUtils1.py:266-272``)
  * ``<scene>/PointsGCS.shp`` — point layer in geo coords with ``inner`` /
    ``object`` scale fields (``MyUtils1.py:64-65``); pixel centers use the
    reference's geo→pixel transform incl. its +1 (``MyUtils1.py:70-72``)
  * ``<scene>/lines.shp`` — RAG edges via ``LEFT_FID``/``RIGHT_FID``
    (``MyUtils2.py:177-193``)

Also the reverse path: write a Scene out as this exact layout (used to
round-trip tests and to export synthetic data for the reference pipeline),
and the ``simi`` write-back (``ExtractFeatures.py:182-219``).
"""

from __future__ import annotations

import os

import numpy as np

from deepmerge_tpu_torch.geodata.geotiff import read_geotiff, write_geotiff
from deepmerge_tpu_torch.geodata.shapefile import (
    DbfField,
    read_point_coords,
    Shape,
    ShapefileTable,
    SHP_POINT,
    SHP_POLYGON,
    SHP_POLYLINE,
)
from deepmerge_tpu_torch.geodata.types import (
    DESIGNED_FEATURE_NAMES,
    EdgeList,
    RegionTable,
    Scene,
)


def load_scene(
    image_path: str,
    polygon_path: str,
    points_path: str,
    lines_path: str | None = None,
    labels: np.ndarray | None = None,
    name: str | None = None,
    deep_pixels: str = "error",
) -> Scene:
    """Assemble a Scene from the reference's file layout.

    ``deep_pixels`` controls rasters deeper than 8 bits (the reference's
    own behavior: ``cut_image`` assigns the GDAL buffer into a
    ``np.zeros(..., dtype=np.uint8)`` destination, ``MyUtils1.py:189-191``,
    so ANY deeper dtype is silently truncated modulo 256 before cv2/``/255``
    ever see it): ``"error"`` (default) refuses instead of silently
    wrapping; ``"wrap"`` reproduces the reference EXACTLY — a C-style
    unsafe cast to uint8 (uint16 keeps the LOW byte, negatives wrap) —
    this is the bit-parity choice for 16-bit imagery, quirk included;
    ``"shift"`` maps the full positive range
    onto uint8 — integer types drop low bits (uint16 → high byte, the
    standard 16→8-bit downscale; signed types clamp negatives — e.g. the
    -32768 nodata fill — to 0 first and use the positive payload bits),
    floats rescale [0, max] linearly; ``"clip"`` clamps to [0, 255] (for
    data already in 8-bit range stored in a wider type).
    """
    tif = read_geotiff(image_path)
    arr = tif.array
    if arr.dtype != np.uint8:
        if deep_pixels == "wrap":
            # the reference's uint8-buffer assignment (MyUtils1.py:189-191)
            arr = arr.astype(np.uint8)
        elif deep_pixels == "shift":
            if arr.dtype.kind in "iu":
                info = np.iinfo(arr.dtype)
                if info.min < 0:  # clamp BEFORE widening: negatives
                    arr = np.maximum(arr, 0)  # (incl. nodata fills) -> 0
                if info.max > 255:
                    # positive payload bits minus 8 (int16 -> >>7 keeps
                    # the full 0..32767 -> 0..255 range; uint16 -> >>8)
                    shift = info.bits - (9 if info.min < 0 else 8)
                    arr = arr.astype(np.uint32) >> shift
            else:  # float rasters (e.g. reflectance in [0, 1])
                arr = np.maximum(arr, 0.0)
                peak = float(arr.max()) if arr.size else 0.0
                if peak > 0:
                    arr = arr * (255.0 / peak)
            arr = np.clip(arr, 0, 255)
        elif deep_pixels == "clip":
            arr = np.clip(arr, 0, 255)
        else:
            raise ValueError(
                f"{image_path}: {arr.dtype} raster; the pipeline stages "
                "uint8 — pass deep_pixels='wrap' (the reference's exact "
                "mod-256 truncation, MyUtils1.py:189-191), 'shift' (drop "
                "low bits) or 'clip'"
            )
    # polygons are consumed attribute-only (designed features + PointID);
    # skipping their vertex parse removes ~40% of ingest time per scene.
    # Point geometry reads through the vectorized fixed-stride parser.
    polys = ShapefileTable.read(polygon_path, with_geometry=False)
    pts = ShapefileTable.read(points_path, with_geometry=False)
    # deletion-flagged records may carry null shapes (OGR filters them before
    # they are ever seen); only live records must have real point geometry
    coords = read_point_coords(points_path, deleted_mask=pts.deleted_mask)
    n_physical = len(pts) if pts.deleted_mask is None \
        else len(pts.deleted_mask)
    if len(coords) != n_physical:
        # a torn .shp (scene mid-copy) can carry fewer records than its
        # sibling .dbf — fail cleanly, never index-mismatch below
        raise ValueError(
            f"{points_path}: {len(coords)} shp records vs "
            f"{n_physical} dbf records — truncated or mismatched "
            "sidecar files"
        )
    if pts.deleted_mask is not None:
        coords = coords[~pts.deleted_mask]
    if len(coords) and not np.isfinite(coords).all():
        raise ValueError(
            f"{points_path}: non-finite point coordinates — corrupt "
            "geometry"
        )

    r = len(polys)
    features = np.zeros((r, len(DESIGNED_FEATURE_NAMES)), np.float32)
    for j, fname in enumerate(DESIGNED_FEATURE_NAMES):
        if fname in polys.field_names():
            col = polys.get_field(fname)
            features[:, j] = [0.0 if v is None else float(v) for v in col]

    # polygon -> sample point ids ("PointID" space-separated field)
    point_ids_per_poly = [
        [int(t) for t in str(v).split(" ") if t not in ("", "None")]
        for v in polys.get_field("PointID")
    ]
    point_region = np.full(len(pts), -1, np.int32)
    for rid, ids in enumerate(point_ids_per_poly):
        for pid in ids:
            if not 0 <= pid < len(pts):
                raise ValueError(
                    f"{polygon_path}: polygon {rid} references point id "
                    f"{pid} outside the {len(pts)}-record point layer — "
                    "truncated or mismatched sidecar files"
                )
            point_region[pid] = rid

    def _int_field(name):
        vals = pts.get_field(name)
        for i, v in enumerate(vals):
            if v is None:
                raise ValueError(
                    f"{points_path}: point record {i} has a blank "
                    f"'{name}' attribute (dBase NULL) — the reference "
                    f"pipeline requires inner/object scales on every point"
                )
        return np.asarray([int(v) for v in vals], np.int32)

    inner = _int_field("inner")
    obj = _int_field("object")

    # vectorized reference geo->pixel incl. the +1 offset
    # (MyUtils1.py:70-72; int() truncation == astype on the abs() value)
    gt = tif.geotransform
    if not (np.isfinite(gt).all() and gt[1] != 0 and gt[5] != 0):
        # corrupt ModelPixelScale/Tiepoint doubles would cast NaN/inf
        # centers to garbage int32 indices with only a RuntimeWarning
        raise ValueError(
            f"{image_path}: corrupt geotransform {tuple(gt)}"
        )
    xp_f = np.abs((gt[0] - coords[:, 0]) / gt[1]) + 1
    yl_f = np.abs((gt[3] - coords[:, 1]) / gt[5]) + 1
    if len(coords) and not (
        np.isfinite(xp_f).all() and np.isfinite(yl_f).all()
        and xp_f.max(initial=0) < 2**31 and yl_f.max(initial=0) < 2**31
    ):
        # a corrupt-but-finite geotransform (e.g. a denormal pixel scale)
        # overflows the int32 cast with only a RuntimeWarning
        raise ValueError(
            f"{image_path}: point coordinates map outside any plausible "
            f"pixel grid (geotransform {tuple(gt)}) — corrupt "
            "georeferencing"
        )
    centers = np.stack([yl_f.astype(np.int32), xp_f.astype(np.int32)],
                       axis=1)

    # region-level inner/object: take each region's first sample point's
    # fields (the reference stores them per point; they are per-region values)
    r_inner = np.full(r, 8, np.int32)
    r_obj = np.full(r, 16, np.int32)
    for rid, ids in enumerate(point_ids_per_poly):
        if ids:
            r_inner[rid] = inner[ids[0]]
            r_obj[rid] = obj[ids[0]]

    keep = point_region >= 0
    regions = RegionTable(
        features=features,
        inner=r_inner,
        object_=r_obj,
        points_yx=centers[keep],
        point_region=point_region[keep],
    )

    edges = np.zeros((0, 2), np.int32)
    if lines_path and os.path.exists(lines_path):
        # attribute-only as well: the RAG needs LEFT_FID/RIGHT_FID, never
        # the polyline vertices
        lines = ShapefileTable.read(lines_path, with_geometry=False)
        lf = lines.get_field("LEFT_FID")
        rf = lines.get_field("RIGHT_FID")
        pairs = [
            (int(a), int(b))
            for a, b in zip(lf, rf)
            if a is not None and b is not None and int(a) >= 0 and int(b) >= 0
        ]
        edges = np.asarray(pairs, np.int32).reshape(-1, 2)

    if labels is None:
        labels = np.zeros(tif.array.shape[:2], np.int32)
    return Scene(
        image=np.ascontiguousarray(arr[..., :3]).astype(np.uint8),
        labels=labels,
        regions=regions,
        rag=EdgeList(edges=edges),
        name=name or os.path.splitext(os.path.basename(image_path))[0],
        meta={"geotransform": tif.geotransform},
    )


class EdgePairDataset:
    """Flat RAG edge-pair dataset across MANY scenes.

    Reference ``PolygonPointPairDataset`` (``MyUtils2.py:18-126``): scan a
    polygon folder for ``<name>.shp`` scenes, read each scene's
    ``lines.shp``, and enumerate every line feature whose ``LEFT_FID``/
    ``RIGHT_FID`` are both valid as one sample
    ``(edge_fid, scene_name, left_id, right_id)``. Differences from the
    reference kept deliberate: the ``i = 17`` debug pin + ``break`` that
    limits the reference to one hardcoded scene are exposed as an optional
    ``scene_limit`` instead, and edge enumeration is lazy per scene file —
    no GDAL datasets are held open.

    ``scenes()`` yields (scene_name, file paths) for driving per-scene
    extraction; ``by_scene()`` groups the flat pairs for padded batch
    scoring (one compiled shape per scene batch).
    """

    def __init__(
        self,
        image_folder: str,
        polygon_folder: str,
        point_folder: str,
        scene_limit: int | None = None,
    ):
        self.image_folder = image_folder
        self.polygon_folder = polygon_folder
        self.point_folder = point_folder
        shp = sorted(
            f for f in os.listdir(polygon_folder) if f.endswith(".shp")
        )
        if scene_limit is not None:
            shp = shp[:scene_limit]
        self.scene_names = [os.path.splitext(f)[0] for f in shp]
        self.data: list[tuple[int, str, int, int]] = []
        for name in self.scene_names:
            lines_path = self.lines_path(name)
            if not os.path.exists(lines_path):
                continue
            lines = ShapefileTable.read(lines_path)
            lf = lines.get_field("LEFT_FID")
            rf = lines.get_field("RIGHT_FID")
            for fid, (a, b) in enumerate(zip(lf, rf)):
                if a is None or b is None:
                    continue
                a, b = int(a), int(b)
                if a < 0 or b < 0:  # scene-border half-edges (same
                    continue       # predicate as load_scene/write_simi)
                self.data.append((fid, name, a, b))

    @classmethod
    def single_scene(
        cls,
        image_path: str,
        polygon_path: str,
        lines_path: str,
        points_path: str,
    ) -> "EdgePairDataset":
        """One explicit scene (reference ``PolygonConnectPointDataset``,
        ``MyUtils2.py:128-209`` — same 4-tuple samples, paths given
        directly instead of folder-derived)."""
        ds = cls.__new__(cls)
        name = os.path.splitext(os.path.basename(polygon_path))[0]
        ds.image_folder = os.path.dirname(image_path)
        ds.polygon_folder = os.path.dirname(polygon_path)
        ds.point_folder = os.path.dirname(os.path.dirname(points_path))
        ds._paths = {name: {
            "image": image_path, "polygons": polygon_path,
            "points": points_path, "lines": lines_path,
        }}
        ds.scene_names = [name]
        ds.data = []
        lines = ShapefileTable.read(lines_path)
        lf = lines.get_field("LEFT_FID")
        rf = lines.get_field("RIGHT_FID")
        for fid, (a, b) in enumerate(zip(lf, rf)):
            if a is None or b is None or int(a) == -1 or int(b) == -1:
                continue
            ds.data.append((fid, name, int(a), int(b)))
        return ds

    # -- reference Dataset protocol ----------------------------------------

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> tuple[int, str, int, int]:
        return self.data[index]

    # -- paths (reference folder layout, MyUtils2.py:50-63; explicit paths
    # when constructed via single_scene) -----------------------------------

    def _path(self, name: str, kind: str, default: str) -> str:
        explicit = getattr(self, "_paths", {})
        if name in explicit:
            return explicit[name][kind]
        return default

    def image_path(self, name: str) -> str:
        return self._path(
            name, "image", os.path.join(self.image_folder, f"{name}.tif")
        )

    def polygon_path(self, name: str) -> str:
        return self._path(
            name, "polygons", os.path.join(self.polygon_folder, f"{name}.shp")
        )

    def points_path(self, name: str) -> str:
        return self._path(
            name, "points",
            os.path.join(self.point_folder, name, "PointsGCS.shp"),
        )

    def lines_path(self, name: str) -> str:
        return self._path(
            name, "lines", os.path.join(self.point_folder, name, "lines.shp")
        )

    # -- TPU-friendly accessors --------------------------------------------

    def scenes(self):
        for name in self.scene_names:
            yield name, {
                "image": self.image_path(name),
                "polygons": self.polygon_path(name),
                "points": self.points_path(name),
                "lines": self.lines_path(name),
            }

    def by_scene(self) -> dict[str, np.ndarray]:
        """scene_name -> (E, 3) int32 [edge_fid, left_id, right_id]."""
        out: dict[str, list] = {}
        for fid, name, a, b in self.data:
            out.setdefault(name, []).append((fid, a, b))
        return {
            k: np.asarray(v, np.int32).reshape(-1, 3) for k, v in out.items()
        }

    def load_scene(self, name: str) -> Scene:
        return load_scene(
            self.image_path(name), self.polygon_path(name),
            self.points_path(name), self.lines_path(name), name=name,
        )


def write_simi(lines_path: str, simi: np.ndarray) -> None:
    """Write scored distances into lines.shp's ``simi`` real field
    (``ExtractFeatures.py:182-186,216-219``).

    OGR ``SetField`` semantics: ONLY the .dbf column is written — geometry
    (.shp/.shx), every other attribute byte and any deletion flags are
    untouched (``shapefile.update_dbf_field``). This is also the serving
    hot path: a full table read+rewrite cost ~0.75 s per 24k-edge scene.
    Valid edges (both FIDs ≥ 0) get ``simi[k]`` in order; invalid rows get
    0; deletion-flagged rows get blanks.
    """
    from deepmerge_tpu_torch.geodata.shapefile import read_dbf_columns, update_dbf_field

    dbf = os.path.splitext(lines_path)[0] + ".dbf"
    cols, deleted = read_dbf_columns(dbf, ["LEFT_FID", "RIGHT_FID"])
    lf, rf = cols["LEFT_FID"], cols["RIGHT_FID"]
    if not any(deleted) and None not in lf and None not in rf:
        # vectorized common case (serving hot path): no deletion flags,
        # no NULL fids — one mask + scatter instead of a 24k-row loop
        lf_a = np.asarray(lf, np.int64)
        rf_a = np.asarray(rf, np.int64)
        valid = (lf_a >= 0) & (rf_a >= 0)
        if int(valid.sum()) != len(simi):
            raise ValueError(
                f"{lines_path}: {len(simi)} scores for "
                f"{int(valid.sum())} valid edges"
            )
        vals = np.zeros(len(lf_a), np.float64)
        vals[valid] = np.asarray(simi, np.float64)
        update_dbf_field(dbf, DbfField("simi", "F", 19, 6), vals.tolist())
        return
    values: list = []
    k = 0
    for i in range(len(lf)):
        if deleted[i]:
            values.append(None)
        elif (lf[i] is not None and rf[i] is not None
              and int(lf[i]) >= 0 and int(rf[i]) >= 0):
            if k >= len(simi):
                raise ValueError(
                    f"{lines_path}: more valid edges than the "
                    f"{len(simi)} scores provided"
                )
            values.append(float(simi[k]))
            k += 1
        else:
            values.append(0)
    if k != len(simi):
        raise ValueError(
            f"{lines_path}: {len(simi)} scores for {k} valid edges"
        )
    update_dbf_field(dbf, DbfField("simi", "F", 19, 6), values)


def export_scene(
    scene: Scene, out_dir: str, compression: str | None = None
) -> dict[str, str]:
    """Write a Scene as the reference's file layout (tif + shp trio)."""
    os.makedirs(out_dir, exist_ok=True)
    sub = os.path.join(out_dir, scene.name)
    os.makedirs(sub, exist_ok=True)
    gt = scene.meta.get("geotransform", (0.0, 1.0, 0.0, 0.0, 0.0, -1.0))

    image_path = os.path.join(out_dir, f"{scene.name}.tif")
    write_geotiff(image_path, scene.image, gt, compression=compression)

    reg = scene.regions
    # point layer (geo coords inverted through the reference transform)
    pt_shapes, pt_records = [], []
    for i in range(reg.num_points):
        y, x = reg.points_yx[i]
        # the reference's abs()+1 geo→pixel transform (MyUtils1.py:70-72)
        # cannot represent pixel row/col 0 — clamp border points to 1
        gx = gt[0] + (max(int(x), 1) - 1) * gt[1]
        gy = gt[3] + (max(int(y), 1) - 1) * gt[5]
        pt_shapes.append(Shape(SHP_POINT, np.array([[gx, gy]], np.float64)))
        rid = int(reg.point_region[i])
        pt_records.append(
            {"inner": int(reg.inner[rid]), "object": int(reg.object_[rid])}
        )
    pts = ShapefileTable(
        SHP_POINT, pt_shapes,
        [DbfField("inner", "N", 10), DbfField("object", "N", 10)],
        pt_records,
    )
    points_path = os.path.join(sub, "PointsGCS.shp")
    pts.save(points_path)

    # polygon layer: bbox placeholder geometry + designed features + PointID
    fields = [DbfField(n, "F", 19, 6) for n in DESIGNED_FEATURE_NAMES]
    fields.append(DbfField("PointID", "C", 254))
    poly_shapes, poly_records = [], []
    pts_of = [[] for _ in range(reg.num_regions)]
    for i, rid in enumerate(reg.point_region):
        pts_of[int(rid)].append(i)
    # one vectorized pass over the label map for ALL region bboxes (the
    # per-region np.where scan was O(R*H*W) — minutes on real mosaics)
    ys_all, xs_all = np.indices(scene.labels.shape)
    flat = scene.labels.ravel()
    R = reg.num_regions
    valid = (flat >= 0) & (flat < R)
    lab = flat[valid]
    yv, xv = ys_all.ravel()[valid], xs_all.ravel()[valid]
    y0 = np.full(R, scene.labels.shape[0], np.int64)
    x0 = np.full(R, scene.labels.shape[1], np.int64)
    y1 = np.full(R, -1, np.int64)
    x1 = np.full(R, -1, np.int64)
    np.minimum.at(y0, lab, yv)
    np.maximum.at(y1, lab, yv)
    np.minimum.at(x0, lab, xv)
    np.maximum.at(x1, lab, xv)
    for rid in range(reg.num_regions):
        if y1[rid] >= 0:
            box = [
                (x0[rid], y0[rid]), (x1[rid] + 1, y0[rid]),
                (x1[rid] + 1, y1[rid] + 1), (x0[rid], y1[rid] + 1),
                (x0[rid], y0[rid]),
            ]
        else:
            box = [(0, 0)] * 5
        ring = np.array(
            [[gt[0] + (x - 1) * gt[1], gt[3] + (y - 1) * gt[5]] for x, y in box],
            np.float64,
        )
        poly_shapes.append(Shape(SHP_POLYGON, ring, np.array([0], np.int32)))
        rec = {
            n: float(scene.regions.features[rid, j])
            for j, n in enumerate(DESIGNED_FEATURE_NAMES)
        }
        rec["PointID"] = " ".join(str(p) for p in pts_of[rid])
        poly_records.append(rec)
    polys = ShapefileTable(SHP_POLYGON, poly_shapes, fields, poly_records)
    polygon_path = os.path.join(out_dir, f"{scene.name}.shp")
    polys.save(polygon_path)

    # RAG lines layer
    line_shapes, line_records = [], []
    for a, b in scene.rag.edges:
        line_shapes.append(
            Shape(SHP_POLYLINE, np.zeros((2, 2), np.float64), np.array([0], np.int32))
        )
        line_records.append({"LEFT_FID": int(a), "RIGHT_FID": int(b)})
    lines = ShapefileTable(
        SHP_POLYLINE, line_shapes,
        [DbfField("LEFT_FID", "N", 10), DbfField("RIGHT_FID", "N", 10)],
        line_records,
    )
    lines_path = os.path.join(sub, "lines.shp")
    lines.save(lines_path)

    return {
        "image": image_path,
        "polygons": polygon_path,
        "points": points_path,
        "lines": lines_path,
    }
