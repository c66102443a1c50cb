"""Class-labeled patch export with a deterministic train/val split (port of
``deepmerge_tpu/geodata/tiles.py``).

Equivalent of the reference's standalone tile exporter
(``OpenVectorWithGDAL.py:60-419``): patches cut around classified points
(``CutImage`` :98-128), a fixed-seed shuffled split (``:76-87,266-311``),
and per-split dumps (``WriteTrain``/``WriteVal``/``WriteTest`` :136-178) as
compressed ``.npz`` shards (``patches``, ``labels``, ``index``), as the JAX
package writes them.

The patches come from the port's patch stage: the scene padded on the
host (``pad_scene``), staged on the device once, and cut by
``extract_multiscale_patches`` (on the card, K1's fused patch kernel for a
window cap up to 256, its gather above), with the zero-padded clipped-window
semantics of ``cut_image``. The patch stage runs on the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepmerge_tpu_torch.ops.patches import (
    extract_multiscale_patches,
    pad_scene,
    slot_caps,
)
from deepmerge_tpu_torch.utils.device import resolve_device


def split_indices(
    n: int, train_frac: float = 0.8, seed: int = 42
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic shuffled train/val split (fixed seed, ref ``:76-87``)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    cut = int(n * train_frac)
    return order[:cut], order[cut:]


def stage_tiles(image: np.ndarray, window: int = 224, max_window: int = 512,
                device: torch.device | str = "cuda"):
    """``(padded scene on device, caps)`` for cutting ``window``-side
    patches of ``image``: the host ``pad_scene`` layout, uploaded once."""
    caps = slot_caps([min(window, max_window)], max_window)
    padded = torch.from_numpy(pad_scene(image, caps))
    return padded.to(resolve_device(device)), caps


def cut_class_patches(
    image: np.ndarray,
    centers_yx: np.ndarray,
    window: int = 224,
    out_size: int = 224,
    max_window: int = 512,
    staged=None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Fixed-window patches around classified points → (N, out, out, C)
    float32 on the host. ``staged`` is ``stage_tiles``' output, to cut many
    batches from one upload (its device wins over ``device``)."""
    padded, caps = staged or stage_tiles(image, window, max_window, device)
    dev = padded.device
    scales = torch.full((len(centers_yx), 1), window, dtype=torch.int32,
                        device=dev)
    (patches,) = extract_multiscale_patches(
        padded, torch.as_tensor(np.asarray(centers_yx), dtype=torch.int32,
                                device=dev),
        scales, patch_sizes=(out_size,), caps=caps,
        out_channels=image.shape[-1],
    )
    return patches.cpu().numpy()


def export_class_patches(
    out_dir: str,
    image: np.ndarray,
    centers_yx: np.ndarray,
    class_ids: np.ndarray,
    window: int = 224,
    out_size: int = 224,
    train_frac: float = 0.8,
    seed: int = 42,
    shard_size: int = 4096,
    device: torch.device | str = "cuda",
) -> dict[str, list[str]]:
    """Cut, split, and write class-labeled patches as .npz shards.

    Patches are cut PER SHARD so host memory is bounded by one shard
    (~shard_size × out² × C float32), not the whole export — a 100k-point
    run would otherwise materialize ~60 GB before the first write.
    """
    os.makedirs(out_dir, exist_ok=True)
    staged = stage_tiles(image, window, 512, device)  # uploaded once
    centers_yx = np.asarray(centers_yx)
    tr, va = split_indices(len(centers_yx), train_frac, seed)
    written: dict[str, list[str]] = {"train": [], "val": []}
    for split, idx in (("train", tr), ("val", va)):
        for shard_no, start in enumerate(range(0, len(idx), shard_size)):
            take = idx[start : start + shard_size]
            path = os.path.join(out_dir, f"{split}_{shard_no:04d}.npz")
            np.savez_compressed(
                path,
                patches=cut_class_patches(
                    image, centers_yx[take], window, out_size, staged=staged,
                ),
                labels=np.asarray(class_ids)[take],
                index=take,
            )
            written[split].append(path)
    return written


def load_patch_shard(path: str) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["patches"], z["labels"]
