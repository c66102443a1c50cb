"""Core geodata data model: Scene / RegionTable / EdgeList.

The reference keeps this state implicit across ESRI shapefiles: a polygon
layer with designed-feature attributes + a ``PointID`` field mapping to
sample points (``MyUtils1.py:266-272``), a point layer with ``inner`` /
``object`` scale fields (``MyUtils1.py:64-65``), and a ``lines.shp`` RAG
edge layer with ``LEFT_FID``/``RIGHT_FID`` (``MyUtils2.py:177-193``). Here
the same information is explicit, columnar, and device-friendly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Designed-feature attribute order (MyUtils1.py:79-114): 15 region attributes;
# the 4 adaptive scale factors are appended downstream to make 19.
DESIGNED_FEATURE_NAMES = (
    "area", "peri", "len", "width", "smooth",
    "std0", "std1", "std2", "mean0", "mean1", "mean2",
    "shapeness", "compact", "bright", "border",
)


@dataclass
class RegionTable:
    """Columnar per-region and per-sample-point data for one scene."""

    features: np.ndarray          # (R, 15) float32 designed attributes
    inner: np.ndarray             # (R,) int32 inner scale field
    object_: np.ndarray           # (R,) int32 object scale field
    points_yx: np.ndarray         # (P, 2) int32 pixel (row, col) sample points
    point_region: np.ndarray      # (P,) int32 owning region id per point

    @property
    def num_regions(self) -> int:
        return int(self.features.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.points_yx.shape[0])

    def point_meta(self):
        """Per-point (features15, inner, object) gathered from regions."""
        r = self.point_region
        return self.features[r], self.inner[r], self.object_[r]


@dataclass
class EdgeList:
    """RAG edges (region-id pairs). ``simi`` holds scored distances."""

    edges: np.ndarray                       # (E, 2) int32
    simi: np.ndarray | None = None          # (E,) float32 after scoring

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])


@dataclass
class Scene:
    """A raster tile plus its superpixel segmentation and RAG."""

    image: np.ndarray             # (H, W, C) uint8
    labels: np.ndarray            # (H, W) int32 superpixel/region label map
    regions: RegionTable
    rag: EdgeList
    object_of_region: np.ndarray | None = None   # (R,) ground-truth object id
    name: str = "scene"
    meta: dict = field(default_factory=dict)

    @property
    def shape(self):
        return self.image.shape
