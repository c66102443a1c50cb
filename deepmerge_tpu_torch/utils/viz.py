"""Label-map / scene visualization (PNG dumps for inspection)."""

from __future__ import annotations

import numpy as np


def colorize_labels(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """(H, W) int labels → (H, W, 3) uint8 with stable random colors."""
    rng = np.random.RandomState(seed)
    n = int(labels.max()) + 1
    palette = rng.randint(40, 255, (max(n, 1), 3)).astype(np.uint8)
    return palette[labels]


def save_label_map(path: str, labels: np.ndarray, image: np.ndarray | None = None,
                   alpha: float = 0.5, seed: int = 0) -> str:
    """Write the colorized label map (optionally blended over the image).

    Returns the path actually written (a .tif sibling when matplotlib is
    unavailable). Real write errors propagate."""
    rgb = colorize_labels(labels, seed).astype(np.float32)
    if image is not None:
        rgb = alpha * rgb + (1 - alpha) * image[..., :3].astype(np.float32)
    out = np.clip(rgb, 0, 255).astype(np.uint8)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        from deepmerge_tpu_torch.geodata.geotiff import write_geotiff

        import os

        fallback = os.path.splitext(path)[0] + ".tif"
        write_geotiff(fallback, out)
        return fallback
    plt.imsave(path, out)
    return path
