"""Scene staging and pair sampling (port of ``deepmerge_tpu/train/sampler.py``).

The raw uint8 tile crosses to the device once and is zero-padded there
(``pad_scene_device``); the per-point metadata stays on the host as numpy,
as in the JAX package. Pair draws use numpy's ``RandomState`` in the JAX
package's order, so every sampler gives the JAX package's point indices,
scales and designed vectors bit for bit; only the containers differ (torch
tensors on the staged scene's device).

Reference semantics reproduced (``MyUtils1.py:18-323``):
  * one random sample-point pair per region pair, RE-DRAWN EVERY EPOCH
    (the reference rebuilds its dataset each epoch: ``Train_SMT.py:217-221``,
    draw at ``MyUtils1.py:275-293``) — here a fresh epoch seed;
  * designed vector = 15 region attributes + 4 adaptive scale factors
    (``MyUtils1.py:76``);
  * only the 3 patch slots the v3 model consumes are materialized, all 4
    factors are kept.

``TripletSampler`` waits for the legacy harness (ROADMAP.md, other
backbones).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from deepmerge_tpu_torch.config import DataConfig
from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.ops.patches import (
    adaptive_scales,
    extract_multiscale_patches,
    pad_scene_device,
    scene_pad,
    staged_channels,
    staging_caps,
)


@dataclass
class DeviceScene:
    """A scene staged for device-side patch extraction."""

    padded: torch.Tensor         # (H+2·pad, W+2·pad, Cs) uint8 on the device
                                 # (Cs = staged_channels: 3-band → RGBA)
    points_yx: np.ndarray        # (P, 2) int32
    point_features: np.ndarray   # (P, 15) designed attributes of owner region
    point_inner: np.ndarray      # (P,)
    point_object: np.ndarray     # (P,)
    point_region: np.ndarray     # (P,)
    caps: tuple[int, ...]        # static per-slot window caps
    channels: int = 3            # ORIGINAL band count (patch slice target)


def stage_scene(scene: Scene, cfg: DataConfig,
                device: torch.device | str = "cpu") -> DeviceScene:
    """Stage ``scene`` on ``device``: caps from the data's adaptive scales
    (warns on clamping), raw tile upload, padding on the device."""
    feats, inner, obj = scene.regions.point_meta()
    caps = staging_caps(inner, obj, cfg.patch_sizes, cfg.max_window,
                        scene_name=scene.name)
    image = torch.from_numpy(np.ascontiguousarray(scene.image)).to(device)
    return DeviceScene(
        padded=pad_scene_device(
            image,
            pad=scene_pad(caps, image.shape[-1]),
            staged_c=staged_channels(image.shape[-1]),
        ),
        points_yx=scene.regions.points_yx,
        point_features=feats,
        point_inner=inner,
        point_object=obj,
        point_region=scene.regions.point_region,
        caps=caps,
        channels=scene.image.shape[-1],
    )


def _targets(cfg: DataConfig) -> tuple:
    return tuple(cfg.patch_sizes) + (1,) * (
        cfg.factor_slots - len(cfg.patch_sizes))


def point_meta(ds: DeviceScene, point_idx: np.ndarray, cfg: DataConfig):
    """(centers (B, 2) int32, scales (B, 4) int32, designed (B, 19)
    float32) on the staged scene's device for a batch of points — the
    light-weight inputs of the fused train step."""
    dev = ds.padded.device
    scales, factors = adaptive_scales(ds.point_inner[point_idx],
                                      ds.point_object[point_idx],
                                      _targets(cfg), device=dev)
    feats = torch.as_tensor(ds.point_features[point_idx],
                            dtype=torch.float32, device=dev)
    centers = torch.as_tensor(ds.points_yx[point_idx], device=dev)
    return centers, scales, torch.cat([feats, factors], dim=1)


def point_batch(ds: DeviceScene, point_idx: np.ndarray, cfg: DataConfig):
    """Materialize (patches, designed) for a batch of sample points: the
    metadata of ``point_meta`` plus the window gather and resize."""
    centers, scales, designed = point_meta(ds, point_idx, cfg)
    patches = extract_multiscale_patches(
        ds.padded,
        centers,
        scales,
        patch_sizes=tuple(cfg.patch_sizes),
        caps=ds.caps,
        chunk=min(256, max(len(point_idx), 8)),
        quantize_uint8=cfg.quantize_uint8,
        out_channels=ds.channels,
    )
    return patches, designed


def _points_of_regions(point_region: np.ndarray, num_regions: int):
    """region id -> array of point indices."""
    order = np.argsort(point_region, kind="stable")
    sorted_r = point_region[order]
    starts = np.searchsorted(sorted_r, np.arange(num_regions))
    ends = np.searchsorted(sorted_r, np.arange(num_regions) + 1)
    return order, starts, ends


class PairSampler:
    """Per-epoch random point-pair draws over positive/negative region pairs,
    the scene staged on ``device``."""

    def __init__(
        self,
        scene: Scene,
        pos_pairs: np.ndarray,
        neg_pairs: np.ndarray,
        cfg: DataConfig,
        device: torch.device | str = "cpu",
    ):
        self.scene = scene
        self.cfg = cfg
        self.device_scene = stage_scene(scene, cfg, device)
        self.pairs = np.concatenate([pos_pairs, neg_pairs], axis=0)
        self.flags = np.concatenate(
            [np.ones(len(pos_pairs)), np.zeros(len(neg_pairs))]
        ).astype(np.float32)
        self._pt_order, self._pt_starts, self._pt_ends = _points_of_regions(
            scene.regions.point_region, scene.regions.num_regions
        )
        # fail LOUDLY on pair files referencing out-of-range or point-less
        # regions (the reference crashes on randint-over-empty-list;
        # silently substituting a neighboring region's point would train
        # on wrong pairs)
        if len(self.pairs):
            ids = self.pairs.ravel()
            bad = (ids < 0) | (ids >= scene.regions.num_regions)
            if bad.any():
                raise ValueError(
                    f"scene '{scene.name}': pair files reference region id "
                    f"{int(ids[bad][0])} outside [0, "
                    f"{scene.regions.num_regions}) — pair ids are per-scene"
                )
            empty = self._pt_starts[ids] == self._pt_ends[ids]
            if empty.any():
                raise ValueError(
                    f"scene '{scene.name}': pair files reference region "
                    f"{int(ids[empty][0])} which has no sample points"
                )

    def _draw_point(self, rng: np.random.RandomState, region: np.ndarray):
        """Vectorized: one uniform sample point per region (ref m_rand/n_rand)."""
        start = self._pt_starts[region]
        count = np.maximum(self._pt_ends[region] - start, 1)
        pick = start + (rng.rand(len(region)) * count).astype(np.int64)
        return self._pt_order[pick]

    def _epoch_draw(self, epoch_seed: int):
        """This epoch's left and right point per pair and its pair order,
        drawn in the JAX package's order."""
        rng = np.random.RandomState(epoch_seed)
        left_pt = self._draw_point(rng, self.pairs[:, 0])
        right_pt = self._draw_point(rng, self.pairs[:, 1])
        return left_pt, right_pt, rng.permutation(len(self.pairs))

    def _flag(self, take):
        return torch.as_tensor(self.flags[take],
                               device=self.device_scene.padded.device)

    def epoch_batches(
        self, epoch_seed: int, batch_size: int, drop_remainder: bool = True
    ) -> Iterator[dict]:
        left_pt, right_pt, perm = self._epoch_draw(epoch_seed)
        n = len(perm)
        if drop_remainder:
            n -= n % batch_size
        for i in range(0, n, batch_size):
            take = perm[i : i + batch_size]
            if drop_remainder and len(take) < batch_size:
                break
            lp, ld = point_batch(self.device_scene, left_pt[take], self.cfg)
            rp, rd = point_batch(self.device_scene, right_pt[take], self.cfg)
            yield {
                "left_patches": lp,
                "right_patches": rp,
                "left_designed": ld,
                "right_designed": rd,
                "flag": self._flag(take),
            }

    def __len__(self) -> int:
        return len(self.pairs)


class MultiScenePairSampler:
    """Training pairs across MANY scenes (the reference iterates pair txt
    files over all training tiles, ``MyUtils1.py:236-295``). Each scene keeps
    its own device staging; epoch batches interleave scenes after a global
    shuffle so one batch draws from one scene."""

    def __init__(self, samplers: list[PairSampler]):
        assert samplers
        self.samplers = samplers

    def __len__(self) -> int:
        return sum(len(s) for s in self.samplers)

    def epoch_batches(self, epoch_seed: int, batch_size: int):
        rng = np.random.RandomState(epoch_seed)
        iters = []
        for i, s in enumerate(self.samplers):
            it = s.epoch_batches((epoch_seed * 131 + i) % (2**32), batch_size)
            n = len(s) // batch_size
            iters.extend([it] * n)
        rng.shuffle(iters)
        for it in iters:
            batch = next(it, None)
            if batch is not None:
                yield batch


class FusedPairSampler(PairSampler):
    """PairSampler variant yielding fused-step batches: per-pair point
    metadata for the stacked [left; right] points instead of materialized
    patches (window gather + resize happen inside the train step).

    Every sample point must lie inside the scene (checked once here): the
    fused step then gathers windows without a bounds check, and so without
    a host synchronisation (``ops/patches``, ``trusted_origins``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        h, w = self.scene.image.shape[:2]
        yx = np.asarray(self.device_scene.points_yx)
        outside = ((yx[:, 0] < 0) | (yx[:, 0] >= h) | (yx[:, 1] < 0)
                   | (yx[:, 1] >= w))
        if outside.any():
            raise ValueError(
                f"scene '{self.scene.name}': {int(outside.sum())} sample "
                f"points lie outside the {h}x{w} image"
            )

    def epoch_batches(self, epoch_seed: int, batch_size: int,
                      drop_remainder: bool = True):
        left_pt, right_pt, perm = self._epoch_draw(epoch_seed)
        n = len(perm)
        if drop_remainder:
            n -= n % batch_size
        for i in range(0, n, batch_size):
            take = perm[i : i + batch_size]
            if drop_remainder and len(take) < batch_size:
                break
            stacked = np.concatenate([left_pt[take], right_pt[take]])
            centers, scales, designed = point_meta(
                self.device_scene, stacked, self.cfg
            )
            yield {
                "centers": centers,
                "scales": scales,
                "designed": designed,
                "flag": self._flag(take),
            }

    def epoch_arrays(self, epoch_seed: int, batch_size: int):
        """Whole-epoch stacked metadata for the scanned-epoch trainer
        (``loop.make_scanned_epoch``): (centers (steps, 2B, 2), scales
        (steps, 2B, 4), designed (steps, 2B, 19), flags (steps, B)) on the
        device, or None when the epoch has no full batch. Vectorized over
        the whole epoch (one ``adaptive_scales`` call, one upload per
        field), value-identical to ``epoch_batches``."""
        left_pt, right_pt, perm = self._epoch_draw(epoch_seed)
        n = len(perm) - len(perm) % batch_size
        if n == 0:
            return None
        take = perm[:n].reshape(-1, batch_size)                # (steps, B)
        stacked = np.concatenate([left_pt[take], right_pt[take]], axis=1)
        steps, twob = stacked.shape                            # (steps, 2B)
        centers, scales, designed = point_meta(
            self.device_scene, stacked.reshape(-1), self.cfg)
        return (
            centers.reshape(steps, twob, 2),
            scales.reshape(steps, twob, -1),
            designed.reshape(steps, twob, -1),
            self._flag(take),
        )
