"""Training-pair and triplet file generation / IO.

Reference equivalents:
  * pair txt files — one line per polygon pair, CSV ``idx,left_id,right_id``
    consumed by the pair dataset (``MyUtils1.py:225-234``) and counted by
    ``GenerateTrainPairData.get_all`` (``GenerateTrainPairData.py:11-44``);
  * triplet txt — random (pos, anchor, neg) label/id 6-tuples from a
    classified point layer (``GenerateTrainDataset.py:26-104``);
  * ``compute_mean_std`` — per-band normalization statistics
    (``Train_SMT.py:60-113``).
"""

from __future__ import annotations

import os

import numpy as np

from deepmerge_tpu_torch.geodata.types import Scene


def write_pair_file(path: str, pairs: np.ndarray) -> None:
    """``idx,left,right`` lines (reference pair txt format)."""
    with open(path, "w") as f:
        for i, (a, b) in enumerate(pairs):
            f.write(f"{i},{int(a)},{int(b)}\n")


def read_pair_file(path: str) -> np.ndarray:
    """Parse a pair txt; returns (N, 2) int32 of (left, right) polygon ids
    (the reference keeps columns 1 and 2, ``MyUtils1.py:231-233``)."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 3:
                pairs.append((int(parts[1]), int(parts[2])))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def scan_pair_folder(folder: str) -> tuple[int, int]:
    """Count files and total pairs (``GenerateTrainPairData.get_all``)."""
    files = [
        os.path.join(folder, f) for f in sorted(os.listdir(folder))
        if f.endswith(".txt")
    ]
    total = sum(len(read_pair_file(f)) for f in files)
    return len(files), total


def read_pair_source(path: str, scene_name: str | None = None) -> np.ndarray:
    """Load pairs from a txt file OR a reference-style pair folder.

    A folder is the reference's ``PositiveData``/``NegativeData`` layout
    (one txt per scene, ``MyUtils1.py:236-258``): with ``scene_name`` set,
    ONLY ``<scene_name>.txt`` loads — region ids are per-scene, so a
    missing file is an error, never a fall-through to other scenes' pairs
    (their ids would silently index the wrong regions). With no
    ``scene_name``, every ``.txt`` in the folder concatenates.
    """
    if os.path.isdir(path):
        if scene_name:
            named = os.path.join(path, f"{scene_name}.txt")
            if not os.path.exists(named):
                raise FileNotFoundError(
                    f"{path} has no pair file for scene '{scene_name}' "
                    f"({scene_name}.txt) — pair region ids are per-scene, "
                    f"so other scenes' files cannot substitute"
                )
            return read_pair_file(named)
        files = [
            os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.endswith(".txt")
        ]
        if not files:
            raise FileNotFoundError(f"no pair .txt files in {path}")
        return np.concatenate([read_pair_file(f) for f in files], axis=0)
    return read_pair_file(path)


def export_training_pairs(scene: Scene, out_dir: str) -> tuple[str, str]:
    """Write positive/negative pair txts for a scene with ground truth
    (the reference's PositiveData/NegativeData folders)."""
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs

    pos, neg = make_training_pairs(scene)
    pos_dir = os.path.join(out_dir, "PositiveData")
    neg_dir = os.path.join(out_dir, "NegativeData")
    os.makedirs(pos_dir, exist_ok=True)
    os.makedirs(neg_dir, exist_ok=True)
    p = os.path.join(pos_dir, f"{scene.name}.txt")
    n = os.path.join(neg_dir, f"{scene.name}.txt")
    write_pair_file(p, pos)
    write_pair_file(n, neg)
    return p, n


def generate_triplets(
    labels: np.ndarray,
    ids: np.ndarray,
    n: int = 20000,
    seed: int = 0,
) -> np.ndarray:
    """Random (pos, anchor, neg) triplets by class
    (``GenerateTrainDataset.py:39-68``): anchor and positive share a class,
    negative comes from a different one. Returns (n, 6) int64 rows of
    (pos_label, pos_id, anchor_label, anchor_id, neg_label, neg_id)."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    ids = np.asarray(ids)
    classes = np.unique(labels)
    if len(classes) < 2:
        raise ValueError("need at least 2 classes for triplets")
    by_class = {c: ids[labels == c] for c in classes}
    rows = np.empty((n, 6), np.int64)
    for i in range(n):
        c_pos, c_neg = rng.choice(classes, 2, replace=False)
        pool = by_class[c_pos]
        anchor, pos = pool[rng.randint(len(pool))], pool[rng.randint(len(pool))]
        neg = by_class[c_neg][rng.randint(len(by_class[c_neg]))]
        rows[i] = (c_pos, pos, c_pos, anchor, c_neg, neg)
    return rows


def write_triplets(path: str, triplets: np.ndarray) -> None:
    with open(path, "w") as f:
        for row in triplets:
            f.write(",".join(str(int(v)) for v in row) + "\n")


def read_triplets(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) == 6:
                rows.append([int(v) for v in parts])
    return np.asarray(rows, np.int64).reshape(-1, 6)


def compute_mean_std(
    patches_by_scale: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Per-band mean/std over /255-normalized patches of the first three
    scale slots (``compute_mean_std``, ``Train_SMT.py:60-113``; note the
    reference reverses the band order BGR→RGB at ``:104-105`` — callers of
    GDAL-band-ordered data should do the same)."""
    flat = np.concatenate(
        [np.asarray(p, np.float64).reshape(-1, p.shape[-1]) for p in patches_by_scale]
    )
    return flat.mean(axis=0).astype(np.float32), flat.std(axis=0).astype(np.float32)
