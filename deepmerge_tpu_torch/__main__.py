"""CLI of the PyTorch port: ``python -m deepmerge_tpu_torch <command>
[--device cuda|cpu] [section.key=value ...]``.

The same commands, arguments and config overrides as ``python -m
deepmerge_tpu``, with ``--device`` in place of ``--platform``:

  train              train on a synthetic scene (or --scene-dir real data)
  extract            extract + score + merge one scene folder
  process-folder     walk a folder of scenes (the serving walk)
  calibrate          pick merge.threshold on a labeled validation scene
  export-synthetic   write a synthetic scene in the reference file layout
  config             print the resolved config

The model commands run on the CUDA card by default; without one they stop
unless ``--device cpu`` is given. ``--checkpoint-dir`` takes a reference
``.pth``; ``train`` writes checkpoints whose ``checkpoint.pth`` is one.
``import-ckpt`` and ``export-ckpt`` are not ported: they say where they
live.

``--mesh`` (``train``, ``extract``, ``process-folder``) runs one process
per rank under torchrun, e.g. ``torchrun --nproc_per_node=N -m
deepmerge_tpu_torch process-folder --mesh ...``: each rank on
``cuda:LOCAL_RANK`` (NCCL), or on the CPU with ``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse
import os
import sys

from deepmerge_tpu_torch.config import Config, apply_overrides

NOT_PORTED = {
    "import-ckpt": "the port reads reference .pth checkpoints directly "
                   "(--checkpoint-dir); `python -m deepmerge_tpu import-ckpt` "
                   "converts them for the JAX package",
    "export-ckpt": "`python -m deepmerge_tpu export-ckpt` writes a JAX "
                   "checkpoint as the reference .pth that the port reads",
}
DEEP_PIXELS = ("error", "wrap", "shift", "clip")


def _majority_object_per_region(labels, objects, num_regions):
    """(R,) majority ground-truth object id per superpixel region.

    Sparse mode-per-region: count unique (region, object) pixel pairs, then
    assign in ascending-count order so each region keeps its largest. Stays
    O(unique pairs) — a dense (R, n_objects) table would blow up on real
    mosaics with 100k regions.
    """
    import numpy as np

    lab = np.asarray(labels).ravel().astype(np.int64)
    obj = np.asarray(objects).ravel()
    # negative ids (-1 nodata conventions) would alias into other regions
    # through the key arithmetic below — drop those pixels instead
    keep = (lab >= 0) & (obj >= 0)
    if not keep.all():
        lab, obj = lab[keep], obj[keep]
    if lab.size and lab.max() >= num_regions:
        raise ValueError(
            f"label map contains region id {int(lab.max())} >= "
            f"num_regions={num_regions}"
        )
    uniq, inv = np.unique(obj, return_inverse=True)
    key, counts = np.unique(lab * len(uniq) + inv, return_counts=True)
    best = np.zeros(num_regions, np.int64)
    order = np.argsort(counts, kind="stable")
    best[key[order] // len(uniq)] = key[order] % len(uniq)
    return uniq[best]


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="deepmerge_tpu_torch")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model runs (default cuda; cpu runs the kernels' "
        "plain PyTorch versions)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train")
    p_train.add_argument("--scene-dir", help="reference-layout data dir")
    p_train.add_argument("--scene-name", help="scene name inside --scene-dir")
    p_train.add_argument("--epochs", type=int)
    p_train.add_argument("--max-steps", type=int)
    p_train.add_argument("--mesh", action="store_true",
                         help="data-parallel training over the torchrun "
                         "ranks (model axis: mesh.model_parallel)")
    p_train.add_argument("--pos-pairs",
                         help="positive pair txt file or folder (the "
                         "reference's PositiveData layout)")
    p_train.add_argument("--neg-pairs",
                         help="negative pair txt file or folder (reference "
                         "NegativeData)")
    p_train.add_argument("overrides", nargs="*", default=[])

    p_ex = sub.add_parser("extract")
    p_ex.add_argument("--image", required=True)
    p_ex.add_argument("--polygons", required=True)
    p_ex.add_argument("--points", required=True)
    p_ex.add_argument("--lines")
    p_ex.add_argument("--h5")
    p_ex.add_argument("--checkpoint-dir", help="reference .pth checkpoint")
    p_ex.add_argument("--labels", help="synthetic-layout labels .npy (optional)")
    p_ex.add_argument("--out-labels", help="write merged label map GeoTIFF here")
    p_ex.add_argument("--out-png", help="write colorized merged map PNG here")
    p_ex.add_argument("--deep-pixels", choices=DEEP_PIXELS, default="error",
                      help="handling for >8-bit rasters (uint16 etc.): "
                      "refuse, drop low bits, or clamp")
    p_ex.add_argument("--mesh", action="store_true",
                      help="shard extraction + merge over the torchrun "
                      "ranks (points split over the data axis; exact "
                      "all_reduce merge rounds)")
    p_ex.add_argument("--stream-tiles", type=int, metavar="N",
                      help="extract through N sequential column-strip tiles "
                      "(identical embeddings and partition)")
    p_ex.add_argument("overrides", nargs="*", default=[])

    p_pf = sub.add_parser("process-folder")
    p_pf.add_argument("--images", required=True)
    p_pf.add_argument("--shapefiles", required=True)
    p_pf.add_argument("--checkpoint-dir", help="reference .pth checkpoint")
    p_pf.add_argument("--mesh", action="store_true",
                      help="shard each scene's extraction + merge over the "
                      "torchrun ranks (rank 0 writes the outputs)")
    p_pf.add_argument("--deep-pixels", choices=DEEP_PIXELS, default="error",
                      help="handling for >8-bit rasters (uint16 etc.)")
    p_pf.add_argument("--write-labelmaps", action="store_true",
                      help="write each scene's merged label map as "
                      "<model>_merged.tif (needs a <name>_labels.npy "
                      "superpixel sidecar per scene)")
    p_pf.add_argument("--stream-tiles", type=int, metavar="N",
                      help="extract each scene through N column strips")
    p_pf.add_argument("--watch", type=float, metavar="SECONDS",
                      help="serving loop: rescan the folder every SECONDS")
    p_pf.add_argument("--watch-iterations", type=int, metavar="K",
                      help="stop after K folder scans (default: until "
                      "killed)")
    p_pf.add_argument("overrides", nargs="*", default=[])

    p_syn = sub.add_parser("export-synthetic")
    p_syn.add_argument("--out", required=True)
    p_syn.add_argument("--size", type=int, default=512)
    p_syn.add_argument("--regions", type=int, default=200)
    p_syn.add_argument("--objects", type=int, default=24)
    p_syn.add_argument("--seed", type=int, default=0)
    p_syn.add_argument("--compress", choices=["none", "deflate"],
                       default="none", help="raster compression (writer)")

    p_cal = sub.add_parser("calibrate")
    p_cal.add_argument("--image", required=True)
    p_cal.add_argument("--polygons", required=True)
    p_cal.add_argument("--points", required=True)
    p_cal.add_argument("--lines")
    p_cal.add_argument("--labels", required=True,
                       help="superpixel label map .npy of the scene")
    p_cal.add_argument("--objects", required=True,
                       help="ground-truth OBJECT map .npy (pixel-level)")
    p_cal.add_argument("--checkpoint-dir", help="reference .pth checkpoint")
    p_cal.add_argument("--deep-pixels", choices=DEEP_PIXELS, default="error",
                       help="handling for >8-bit rasters (uint16 etc.)")
    p_cal.add_argument("overrides", nargs="*", default=[])

    p_cfg = sub.add_parser("config")
    p_cfg.add_argument("overrides", nargs="*", default=[])

    for cmd, where in NOT_PORTED.items():
        p = sub.add_parser(cmd, help=f"not ported: {where}")
        p.add_argument("rest", nargs=argparse.REMAINDER)
    return parser


def _load_cli_scene(scene_dir: str, name: str):
    """A scene of ``scene_dir`` with its export-synthetic sidecars
    (``{name}_labels.npy`` superpixel map, ``{name}_objects.npy``
    ground-truth object map — with them a dir trains directly, no pair
    txts)."""
    import numpy as np

    from deepmerge_tpu_torch.geodata.ingest import load_scene

    labels_npy = os.path.join(scene_dir, f"{name}_labels.npy")
    objects_npy = os.path.join(scene_dir, f"{name}_objects.npy")
    labels = np.load(labels_npy) if os.path.exists(labels_npy) else None
    scene = load_scene(
        os.path.join(scene_dir, f"{name}.tif"),
        os.path.join(scene_dir, f"{name}.shp"),
        os.path.join(scene_dir, name, "PointsGCS.shp"),
        os.path.join(scene_dir, name, "lines.shp"),
        labels=labels, name=name,
    )
    if labels is not None and os.path.exists(objects_npy):
        scene.object_of_region = _majority_object_per_region(
            labels, np.load(objects_npy), scene.regions.num_regions)
    return scene


def _train(parser, args, cfg, device, use_mesh=False) -> int:
    """The ``train`` command: the JAX CLI's scene and pair handling, then
    ``train.driver.train`` on ``device``."""
    import dataclasses

    from deepmerge_tpu_torch.train.driver import train

    if args.epochs is not None:
        cfg = cfg.replace(
            train=dataclasses.replace(cfg.train, num_epochs=args.epochs))
    scene = None
    if args.scene_dir:
        if args.scene_name:
            scene = _load_cli_scene(args.scene_dir, args.scene_name)
        else:
            # no --scene-name: train over EVERY scene in the dir (the
            # reference iterates pair files over all training tiles,
            # MyUtils1.py:236-295); each needs its ground-truth sidecars
            if args.pos_pairs or args.neg_pairs:
                parser.error("--pos-pairs/--neg-pairs need --scene-name: "
                             "pair ids are per-scene")
            names = sorted(
                os.path.splitext(f)[0] for f in os.listdir(args.scene_dir)
                if f.endswith(".shp") and os.path.exists(os.path.join(
                    args.scene_dir, os.path.splitext(f)[0], "PointsGCS.shp"))
            )
            if not names:
                parser.error(f"--scene-dir {args.scene_dir}: no scenes found "
                             "(<name>.shp + <name>/PointsGCS.shp layout)")
            scene = [_load_cli_scene(args.scene_dir, n) for n in names]
            for s in scene:
                if s.object_of_region is None:
                    parser.error(
                        f"scene '{s.name}' has no ground-truth sidecars "
                        "({name}_labels.npy + {name}_objects.npy) — "
                        "multi-scene training derives pairs from them")
            print(f"training over {len(scene)} scenes: "
                  f"{[s.name for s in scene]}")
            if len(scene) == 1:
                scene = scene[0]
    pos_pairs = neg_pairs = None
    if args.pos_pairs or args.neg_pairs:
        if not (args.pos_pairs and args.neg_pairs):
            parser.error("--pos-pairs and --neg-pairs go together")
        if scene is None:
            parser.error("--pos-pairs/--neg-pairs need --scene-dir "
                         "(+ --scene-name): pair ids are per-scene")
        from deepmerge_tpu_torch.geodata.pairgen import read_pair_source

        pos_pairs = read_pair_source(args.pos_pairs, args.scene_name)
        neg_pairs = read_pair_source(args.neg_pairs, args.scene_name)
    train(cfg, scene=scene, pos_pairs=pos_pairs, neg_pairs=neg_pairs,
          use_mesh=use_mesh, max_steps_per_epoch=args.max_steps,
          device=device)
    return 0


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"deepmerge_tpu_torch {args.cmd}: {NOT_PORTED[args.cmd]}",
              file=sys.stderr)
        return 2
    cfg = apply_overrides(Config(), getattr(args, "overrides", []))

    if args.cmd == "config":
        print(cfg.to_json())
        return 0

    if args.cmd == "export-synthetic":
        import numpy as np

        from deepmerge_tpu_torch.geodata.ingest import export_scene
        from deepmerge_tpu_torch.geodata.synthetic import generate_scene

        scene = generate_scene(h=args.size, w=args.size,
                               n_regions=args.regions,
                               n_objects=args.objects, seed=args.seed)
        paths = export_scene(
            scene, args.out,
            compression=None if args.compress == "none" else args.compress,
        )
        paths["labels"] = os.path.join(args.out, f"{scene.name}_labels.npy")
        np.save(paths["labels"], scene.labels)
        paths["objects"] = os.path.join(args.out, f"{scene.name}_objects.npy")
        np.save(paths["objects"], scene.object_of_region[scene.labels])
        for k, v in paths.items():
            print(f"{k}: {v}")
        return 0

    import torch

    use_mesh = getattr(args, "mesh", False)
    if use_mesh and getattr(args, "stream_tiles", None):
        parser.error("--mesh and --stream-tiles are exclusive: a mesh "
                     "already spreads the scene across ranks")
    if use_mesh:
        import torch.distributed as dist

        from deepmerge_tpu_torch.parallel.distributed import initialize
        from deepmerge_tpu_torch.parallel.mesh import NO_GROUP, make_mesh

        initialize(device=args.device)  # torchrun's group; else a no-op
        if not dist.is_initialized():
            print(f"deepmerge_tpu_torch {args.cmd} --mesh: {NO_GROUP}",
                  file=sys.stderr)
            return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card found: the port's kernels need one; pass "
                     "--device cpu to run their plain versions on the CPU")
    device = torch.device(args.device)
    mesh = None
    if use_mesh:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        if args.cmd != "train":
            mesh = make_mesh(n_data=dist.get_world_size(), n_model=1,
                             devices=device)

    if args.cmd == "train":
        return _train(parser, args, cfg, device, use_mesh)

    if args.cmd == "extract":
        import numpy as np

        from deepmerge_tpu_torch.geodata.ingest import load_scene
        from deepmerge_tpu_torch.infer.driver import load_params, process_scene
        from deepmerge_tpu_torch.infer.extract import FeatureStore

        labels = None
        if args.labels:
            labels = np.load(args.labels)
        elif args.out_labels or args.out_png:
            parser.error("--out-labels/--out-png need --labels (the "
                         "superpixel label map); without it the merged map "
                         "would be meaningless")
        scene = load_scene(args.image, args.polygons, args.points, args.lines,
                           deep_pixels=args.deep_pixels, labels=labels)
        model = load_params(cfg, args.checkpoint_dir)
        writer = mesh is None or mesh.rank == 0
        emb, simi, result = process_scene(
            cfg, scene, model,
            store=FeatureStore(args.h5) if args.h5 and writer else None,
            lines_path=args.lines, mesh=mesh,
            stream_tiles=args.stream_tiles, device=device,
        )
        print(f"embedded {emb.shape[0]} points; scored {len(simi)} edges")
        if writer and result is not None and (args.out_labels
                                              or args.out_png):
            label_map = result.label_map(scene)
            if args.out_labels:
                from deepmerge_tpu_torch.infer.merge import (
                    write_label_geotiff,
                )

                write_label_geotiff(args.out_labels, label_map,
                                    scene.meta.get("geotransform"))
                print(f"merged label map -> {args.out_labels}")
            if args.out_png:
                from deepmerge_tpu_torch.utils.viz import save_label_map

                written = save_label_map(args.out_png, label_map, scene.image)
                print(f"visualization -> {written}")
        return 0

    if args.cmd == "calibrate":
        import numpy as np

        from deepmerge_tpu_torch.geodata.ingest import load_scene
        from deepmerge_tpu_torch.infer.calibrate import calibrate_threshold
        from deepmerge_tpu_torch.infer.driver import load_params
        from deepmerge_tpu_torch.infer.extract import FeatureExtractor

        labels = np.load(args.labels)
        scene = load_scene(args.image, args.polygons, args.points,
                           args.lines, labels=labels,
                           deep_pixels=args.deep_pixels)
        region_objects = _majority_object_per_region(
            labels, np.load(args.objects), scene.regions.num_regions)
        extractor = FeatureExtractor(
            load_params(cfg, args.checkpoint_dir),
            batch_size=min(cfg.data.eval_batch_size,
                           scene.regions.num_points),
            device=device,
        )
        emb = extractor.extract_scene(scene, cfg.data)
        cal = calibrate_threshold(scene, emb, region_objects=region_objects,
                                  max_rounds=cfg.merge.max_rounds)
        print(cal)
        print(f"override: merge.threshold={cal.threshold:.6f}")
        return 0

    if args.cmd == "process-folder":
        from deepmerge_tpu_torch.infer.driver import process_folder

        done = process_folder(cfg, args.images, args.shapefiles,
                              args.checkpoint_dir,
                              deep_pixels=args.deep_pixels,
                              write_labelmaps=args.write_labelmaps,
                              stream_tiles=args.stream_tiles,
                              watch_seconds=args.watch,
                              watch_iterations=args.watch_iterations,
                              mesh=mesh, device=device)
        print(f"processed {len(done)} scenes")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
