"""Batched region-embedding extraction, the feature store and the
segment-and-merge path (port of ``deepmerge_tpu/infer/extract.py``).

``segment_scene_device`` runs the whole pipeline on one device: for each
balanced chunk of sample points, window gather (K1) → crop + INTER_AREA
resize → S2Former forward (for v3: K2 for stage 0, K3 for stages 1 and 2,
or K4 for both when the model is quantized; K7 in every block off the block
kernels); then region pooling → edge scoring →
threshold → merge rounds → the dense (H, W) merged label map. The JAX
package compiles this into one program; here it is a plain sequence of
calls on the current stream. ``extract_scene`` embeds in fixed-size padded
batches for a ``FeatureStore``, and ``extract_scene_streamed`` stages one
column strip of the scene at a time.
"""

from __future__ import annotations

import bisect
import logging
from typing import Optional

import numpy as np
import torch

from deepmerge_tpu_torch.config import DataConfig
from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.ops.labelprop import (
    device_score_and_merge,
    merged_label_map,
)
from deepmerge_tpu_torch.ops.patches import (
    adaptive_scales,
    extract_multiscale_patches,
    pad_scene_device,
    scene_pad,
    staged_channels,
    staging_caps,
)
from deepmerge_tpu_torch.train.sampler import DeviceScene, stage_scene

try:
    import h5py

    HAS_H5PY = True
except Exception:  # pragma: no cover - h5py is optional
    HAS_H5PY = False


class FeatureStore:
    """Append-only embedding store in the reference's HDF5 layout (one
    growable dataset named ``"dataset"``), or in memory when ``path`` is
    None."""

    def __init__(self, path: Optional[str] = None,
                 dataset_name: str = "dataset"):
        self.path = path
        self.dataset_name = dataset_name
        self._chunks: list[np.ndarray] = []
        # cumulative row offsets of the in-memory chunks
        self._offsets: list[int] = [0]
        self._h5 = None
        if path is not None:
            if not HAS_H5PY:
                raise RuntimeError("h5py unavailable; use in-memory store")
            self._h5 = h5py.File(path, "w")

    def append(self, data: np.ndarray) -> None:
        if self._h5 is not None:
            if self.dataset_name not in self._h5:
                self._h5.create_dataset(
                    self.dataset_name, data=data,
                    maxshape=(None,) + data.shape[1:], chunks=True,
                )
            else:
                ds = self._h5[self.dataset_name]
                old = ds.shape[0]
                ds.resize((old + data.shape[0],) + data.shape[1:])
                ds[old:] = data
        else:
            data = np.asarray(data)
            self._chunks.append(data)
            self._offsets.append(self._offsets[-1] + data.shape[0])

    def read_all(self) -> np.ndarray:
        if self._h5 is not None:
            return np.asarray(self._h5[self.dataset_name])
        return np.concatenate(self._chunks, axis=0)

    def get_by_id(self, idx: int) -> np.ndarray:
        """Random access by point FID."""
        if self._h5 is not None:
            return np.asarray(self._h5[self.dataset_name][idx])
        n = self._offsets[-1]
        i = idx + n if idx < 0 else idx
        if not 0 <= i < n:
            raise IndexError(f"index {idx} out of range for store of {n}")
        c = bisect.bisect_right(self._offsets, i) - 1
        return self._chunks[c][i - self._offsets[c]]

    def close(self) -> None:
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    @staticmethod
    def open(path: str, dataset_name: str = "dataset") -> np.ndarray:
        if not HAS_H5PY:
            raise RuntimeError("h5py unavailable")
        with h5py.File(path, "r") as f:
            return np.asarray(f[dataset_name])


def _plan_strips(scene: Scene, caps, xs: np.ndarray, order: np.ndarray,
                 n_strips: int):
    """Contiguous x-sorted point groups and per-strip crop bounds: each
    strip covers its points' x-range ± ``scene_pad`` (the gather's exact
    reach), all strips padded to the widest."""
    halo = scene_pad(caps, scene.image.shape[-1])
    w = scene.image.shape[1]
    groups = [g for g in np.array_split(order, n_strips) if len(g)]
    bounds = []
    for g in groups:
        gx = xs[g]
        bounds.append((max(int(gx.min()) - halo, 0),
                       min(int(gx.max()) + halo + 1, w)))
    wmax = max(xhi - xlo for xlo, xhi in bounds)
    return groups, bounds, wmax


def _strips_for_budget(scene: Scene, caps, xs: np.ndarray, order: np.ndarray,
                       budget_bytes: int, max_strips: int = 256) -> int:
    """Smallest strip count whose staged tile fits ``budget_bytes``."""
    h = scene.image.shape[0]
    p = scene_pad(caps, scene.image.shape[-1])
    cs = staged_channels(scene.image.shape[-1])
    for ns in range(1, max_strips + 1):
        _, _, wmax = _plan_strips(scene, caps, xs, order, ns)
        if (h + 2 * p) * (wmax + 2 * p) * cs <= budget_bytes:
            return ns
    raise ValueError(
        f"no column-strip split of scene '{scene.name}' fits "
        f"{budget_bytes} bytes (halo alone is {p} px per side; "
        f"{max_strips} strips still stage "
        f"{(h + 2 * p) * (wmax + 2 * p) * cs} bytes)"
    )


def region_bucket(num_regions: int, granularity: int = 256) -> int:
    """Region-axis size rounded up to a bucket. Phantom regions have no
    points and no edges, so they stay singleton clusters that never touch
    the real partition."""
    return -(-max(num_regions, 1) // granularity) * granularity


def unpack_serve_tail(tail, n_edges_padded: int, num_edges: int,
                      num_regions: int):
    """Decode the f32 serving tail ``[simi | labels | rounds]`` of
    ``segment_scene_device(..., serve_packed=True)`` into ``(simi
    (num_edges,) f32, labels (num_regions,) int32, rounds int)``. Labels
    are exact through f32 up to 2^24 regions."""
    if isinstance(tail, torch.Tensor):
        tail = tail.cpu().numpy()
    tail = np.asarray(tail, np.float32)
    simi = tail[:n_edges_padded][:num_edges]
    labels = tail[n_edges_padded:n_edges_padded + num_regions].astype(
        np.int32)
    return simi, labels, int(tail[-1])


class FeatureExtractor:
    """Embeds every sample point of a scene with a port ``S2Former``.

    The constructor moves the model to ``device``, casts its float weights
    to the model dtype once (the LayerNorm parameters and the bias tables
    included, as the JAX package does; its float buffers — calibrated
    ``w8a8-static`` scales, the aux heads' BatchNorm statistics — stay
    float32, as the JAX package keeps its ``batch_stats``), and puts it in
    eval mode. A ``w8a8-static`` model without scales calibrates on the
    first chunk it serves. The aux heads of v4 and v5 do not run here.
    """

    def __init__(self, model: torch.nn.Module, batch_size: int = 2000,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        stats = {n: b for n, b in model.named_buffers()
                 if b.is_floating_point()}
        # float weights only: the int64 index buffers keep their dtype
        model = model.to(self.device, model.dtype)
        for n, b in stats.items():
            owner, _, attr = n.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    b.to(self.device, torch.float32))
        self.model = model.eval()
        self.batch_size = batch_size

    # -- inputs -------------------------------------------------------------

    def _targets(self, cfg: DataConfig) -> tuple:
        return tuple(cfg.patch_sizes) + (1,) * (
            cfg.factor_slots - len(cfg.patch_sizes))

    def _chunked_inputs(self, ds: DeviceScene, cfg: DataConfig):
        """Per-point inputs, chunked and on the device, cached on the staged
        scene (not keyed by ``id(ds)``: ids are reused after collection)."""
        key = (self.batch_size, cfg.patch_sizes, cfg.factor_slots)
        cache = ds.__dict__.setdefault("_chunked_inputs_cache", {})
        if key not in cache:
            cache[key] = self._chunked_inputs_uncached(ds, cfg)
        return cache[key]

    def _chunked_inputs_uncached(self, ds: DeviceScene, cfg: DataConfig):
        """Balanced chunks: the points ceil-divided over the fewest chunks of
        at most ``batch_size`` (8-row aligned), the tail padded with point
        0. Returns ``(n, nb, (centers, scales, factors, feats))``, each
        (nb, bs, ·)."""
        n = ds.points_yx.shape[0]
        if n == 0:
            raise ValueError("scene has no sample points — nothing to extract")
        nb_min = max(-(-n // self.batch_size), 1)
        per_chunk = -(-n // nb_min)
        bs = min(-(-per_chunk // 8) * 8, max(n, 1))
        pad = (-n) % bs
        idx = np.arange(n + pad)
        if pad:
            idx[n:] = 0
        nb = len(idx) // bs
        centers, scales, factors, feats = self._point_inputs(
            ds.points_yx[idx], ds.point_inner[idx], ds.point_object[idx],
            ds.point_features[idx], cfg)
        return n, nb, (centers.reshape(nb, bs, 2), scales.reshape(nb, bs, -1),
                       factors.reshape(nb, bs, -1), feats.reshape(nb, bs, -1))

    def _point_inputs(self, points_yx, inner, obj, feats, cfg: DataConfig):
        """(centers, scales, factors, feats) of a set of points, on the
        device."""
        dev = self.device
        scales, factors = adaptive_scales(inner, obj, self._targets(cfg),
                                          device=dev)
        return (torch.as_tensor(points_yx, dtype=torch.int32).to(dev),
                scales, factors,
                torch.as_tensor(feats, dtype=torch.float32).to(dev))

    def _padded_point_region(self, ds: DeviceScene, r_pad: int, total: int):
        """Point→region ids padded to ``total`` with the pad id ``r_pad``,
        on the device, cached on the staged scene."""
        cache = ds.__dict__.setdefault("_padded_pr_cache", {})
        key = (r_pad, total)
        if key not in cache:
            prp = np.full(total, r_pad, np.int32)
            prp[: ds.point_region.shape[0]] = ds.point_region
            cache[key] = torch.from_numpy(prp).to(self.device)
        return cache[key]

    # -- forward ------------------------------------------------------------

    def _model_inputs(self, padded, caps, quantize_uint8, centers, scales,
                      factors, feats):
        mcfg = self.model.cfg
        patches = extract_multiscale_patches(
            padded, centers, scales,
            patch_sizes=tuple(mcfg.input_image_scales), caps=caps,
            quantize_uint8=quantize_uint8, out_channels=mcfg.in_channels,
            out_dtype=self.model.dtype,
        )
        return patches, torch.cat([feats, factors], dim=1)

    @property
    def needs_calibration(self) -> bool:
        """True while a ``w8a8-static`` model has no activation scales."""
        m = self.model
        return bool(m._static_blocks()) and not m.act_amax_calibrated

    @torch.inference_mode()
    def _maybe_calibrate(self, padded, caps, quantize_uint8, centers, scales,
                         factors, feats) -> None:
        """One-time ``w8a8-static`` calibration on the batch about to be
        served (the first chunk or batch of the first scene, as in the JAX
        package); a no-op once the model has its scales."""
        if not self.needs_calibration:
            return
        logging.getLogger(__name__).info(
            "calibrating w8a8-static activation scales on the first batch")
        self.model.calibrate(*self._model_inputs(
            padded, caps, quantize_uint8, centers, scales, factors, feats))

    @torch.inference_mode()
    def _embed(self, padded, caps, quantize_uint8, centers, scales, factors,
               feats) -> torch.Tensor:
        """Embeddings of one batch of points, in the model dtype."""
        return self.model(*self._model_inputs(
            padded, caps, quantize_uint8, centers, scales, factors, feats))

    def _embed_chunks(self, ds: DeviceScene, cfg: DataConfig,
                      args) -> torch.Tensor:
        """Embeddings of every chunk row (pad rows included), (nb·bs, D),
        in the model dtype; a ``w8a8-static`` model calibrates on chunk 0."""
        common = (ds.padded, ds.caps, cfg.quantize_uint8)
        self._maybe_calibrate(*common, *(a[0] for a in args))
        return torch.cat([self._embed(*common, *chunk)
                          for chunk in zip(*args)], dim=0)

    def _extract_batches(self, scene: Scene, cfg: DataConfig,
                         device_scene: Optional[DeviceScene]):
        """Embeddings in fixed batches of ``batch_size`` points, the last
        padded with point 0 and cut back."""
        ds = device_scene or stage_scene(scene, cfg, self.device)
        n = ds.points_yx.shape[0]
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = np.arange(start, min(start + bs, n))
            pad = bs - len(idx)
            if pad:
                idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            args = self._point_inputs(
                ds.points_yx[idx], ds.point_inner[idx], ds.point_object[idx],
                ds.point_features[idx], cfg)
            common = (ds.padded, ds.caps, cfg.quantize_uint8)
            self._maybe_calibrate(*common, *args)
            emb = self._embed(*common, *args)
            yield emb[: bs - pad] if pad else emb

    def extract_scene(self, scene: Scene, cfg: DataConfig,
                      store: Optional[FeatureStore] = None,
                      device_scene: Optional[DeviceScene] = None
                      ) -> np.ndarray:
        """Embed all sample points; (P, out_dim) float32 on the host,
        appended batch by batch to ``store``."""
        out = []
        for emb in self._extract_batches(scene, cfg, device_scene):
            emb = emb.to(torch.float32).cpu().numpy()
            if store is not None:
                store.append(emb)
            out.append(emb)
        return np.concatenate(out, axis=0)

    def extract_scene_device(self, scene: Scene, cfg: DataConfig,
                             device_scene: Optional[DeviceScene] = None
                             ) -> torch.Tensor:
        """Embed all sample points; (P, out_dim) float32 on the device."""
        ds = device_scene or stage_scene(scene, cfg, self.device)
        n, _, args = self._chunked_inputs(ds, cfg)
        return self._embed_chunks(ds, cfg, args)[:n].to(torch.float32)

    def extract_scene_streamed(self, scene: Scene, cfg: DataConfig,
                               n_strips: int | None = None,
                               hbm_budget_bytes: int | None = None,
                               store: Optional[FeatureStore] = None
                               ) -> np.ndarray:
        """Embed all points without staging the whole scene on the device:
        one column strip at a time (the strip's points' x-range plus the
        gather's halo, so every patch byte equals whole-scene staging), all
        strips padded to one width. Embeddings come back in point-FID order
        on the host. Pass ``n_strips``, or ``hbm_budget_bytes`` to pick the
        fewest strips whose staged tile fits."""
        n = scene.regions.num_points
        if n == 0:
            raise ValueError("scene has no sample points — nothing to extract")
        feats_all, inner_all, obj_all = scene.regions.point_meta()
        # the caps of the whole scene, as whole-scene staging uses them
        caps = staging_caps(inner_all, obj_all, cfg.patch_sizes,
                            cfg.max_window, scene_name=scene.name)
        xs = scene.regions.points_yx[:, 1].astype(np.int64)
        order = np.argsort(xs, kind="stable")
        if n_strips is None:
            if hbm_budget_bytes is None:
                raise ValueError("pass n_strips or hbm_budget_bytes")
            n_strips = _strips_for_budget(scene, caps, xs, order,
                                          hbm_budget_bytes)
        groups, bounds, wmax = _plan_strips(scene, caps, xs, order, n_strips)

        h = scene.image.shape[0]
        c = scene.image.shape[-1]
        bs = self.batch_size
        out = None
        for g, (xlo, xhi) in zip(groups, bounds):
            tile = np.zeros((h, wmax, c), scene.image.dtype)
            tile[:, : xhi - xlo] = scene.image[:, xlo:xhi]
            padded = pad_scene_device(
                torch.from_numpy(tile).to(self.device),
                pad=scene_pad(caps, c), staged_c=staged_channels(c),
            )
            centers = scene.regions.points_yx[g].astype(np.int32).copy()
            centers[:, 1] -= xlo
            for start in range(0, len(g), bs):
                idx = np.arange(start, min(start + bs, len(g)))
                pad = bs - len(idx)
                if pad:
                    idx = np.concatenate([idx, np.zeros(pad, np.int64)])
                gi = g[idx]
                args = self._point_inputs(centers[idx], inner_all[gi],
                                          obj_all[gi], feats_all[gi], cfg)
                common = (padded, caps, cfg.quantize_uint8)
                self._maybe_calibrate(*common, *args)
                emb = self._embed(*common, *args).to(torch.float32)
                emb = emb.cpu().numpy()
                if out is None:
                    out = np.empty((n, emb.shape[-1]), np.float32)
                real = bs - pad
                out[g[idx[:real]]] = emb[:real]
            del padded  # free the strip before staging the next
        if store is not None:
            store.append(out)  # once, in point-FID order
        return out

    @torch.inference_mode()
    def segment_scene_device(
        self,
        scene: Scene,
        cfg: DataConfig,
        edges,
        edge_valid,
        num_regions: int,
        max_rounds: int = 16,
        device_scene: Optional[DeviceScene] = None,
        region_map=None,
        threshold=None,
        threshold_quantile: float = 0.5,
        with_embeddings: bool = False,
        serve_packed: bool = False,
    ):
        """Extract, pool, score and merge a scene on the device.

        ``edges``/``edge_valid`` are the padded RAG arrays (numpy or
        tensors). Labels come back over the bucketed region axis
        (``region_bucket(num_regions)``; slice ``[:num_regions]``).
        ``threshold`` is an absolute merge threshold; None thresholds at
        ``threshold_quantile`` of the valid edge distances.

        Returns ``(simi, labels, rounds)``, or with ``region_map`` (the
        (H, W) superpixel-id map) ``(simi, labels, rounds, label_map,
        n_clusters)``, where ``n_clusters`` counts real clusters only.
        ``with_embeddings`` appends the embeddings over the padded point
        axis in the model dtype (slice ``[:num_points]``). ``serve_packed``
        returns ``(emb, tail)`` instead: those embeddings and one f32 tail
        ``[simi | labels | rounds]`` (``unpack_serve_tail``), two pulls to
        the host for the whole scene.
        """
        if serve_packed and region_map is not None:
            raise ValueError("serve_packed has no label-map output")
        ds = device_scene or stage_scene(scene, cfg, self.device)
        _, _, args = self._chunked_inputs(ds, cfg)
        r_pad = region_bucket(num_regions)
        emb = self._embed_chunks(ds, cfg, args)
        pr = self._padded_point_region(ds, r_pad, emb.shape[0])
        dev = self.device
        simi, labels, rounds = device_score_and_merge(
            emb.to(torch.float32), pr,
            torch.as_tensor(edges, device=dev),
            torch.as_tensor(edge_valid, device=dev),
            num_regions=r_pad, max_rounds=max_rounds,
            threshold=threshold, threshold_quantile=threshold_quantile,
        )
        if serve_packed:
            tail = torch.cat([simi.to(torch.float32),
                              labels.to(torch.float32),
                              rounds.to(torch.float32).reshape(1)])
            return emb, tail
        out = (simi, labels, rounds)
        if region_map is not None:
            out += merged_label_map(
                labels, torch.as_tensor(region_map, device=dev), num_regions)
        return out + (emb,) if with_embeddings else out
