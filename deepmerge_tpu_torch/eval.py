"""End-to-end quality evaluation on the PyTorch port: train → merge held-out
scenes → report (port of the repository's root ``eval.py``).

Trains an S2Former (``--variant``) on one synthetic scene with the port's
``train``, then segments and merges DIFFERENT scenes and compares the
partition with their ground-truth object maps. The defaults are the root
script's small smoke configuration (embed 128, 4 heads of width 32, depth
2/1/1); ``--full`` switches to the flagship EVAL.md run (1024x1024 scenes, 2048 regions, 100 epochs). Runs on
the card unless ``--device cpu``.

  python -m deepmerge_tpu_torch.eval                   # smoke, on the card
  python -m deepmerge_tpu_torch.eval --device cpu      # on the CPU
  python -m deepmerge_tpu_torch.eval --full --calibrate

Prints one result line per held-out scene plus a JSON summary tail, with
the root ``eval.py``'s keys and ``device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time


def serve_held_out(cfg, model, scene_kw: dict, test_seeds, *,
                   threshold: float = 1.0, calibrate: bool = False,
                   val_seed: int = 500, device="cuda", log_fn=print):
    """The serving half: embed a validation scene and calibrate the merge
    threshold on it (``calibrate``), then embed and merge each held-out
    scene of ``generate_scene(seed, **scene_kw)`` and score its partition
    against the ground-truth objects. ``model`` is the port's model for
    ``cfg.model`` with its weights. Returns ``(threshold, calibration,
    results)`` in the JSON tail's form."""
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.infer.merge import merge_scene_device
    from deepmerge_tpu_torch.utils.parity import pair_disagreement

    points = scene_kw["n_regions"] * scene_kw["points_per_region"]
    extractor = FeatureExtractor(model, batch_size=min(2000, points),
                                 device=device)
    calibration = None
    if calibrate:
        from deepmerge_tpu_torch.infer.calibrate import calibrate_threshold

        val_scene = generate_scene(seed=val_seed, **scene_kw)
        val_emb = extractor.extract_scene(val_scene, cfg.data)
        cal = calibrate_threshold(val_scene, val_emb,
                                  max_rounds=cfg.merge.max_rounds)
        threshold = cal.threshold
        calibration = {
            "val_seed": val_seed,
            "threshold": round(cal.threshold, 6),
            "val_disagreement": round(cal.disagreement, 6),
        }
        log_fn(f"[eval] {cal}")

    results = []
    for seed in test_seeds:
        scene = generate_scene(seed=seed, **scene_kw)
        emb = extractor.extract_scene(scene, cfg.data)
        merged = merge_scene_device(scene, emb, threshold=threshold,
                                    max_rounds=cfg.merge.max_rounds)
        pred = merged.region_to_cluster[scene.labels]
        gt = scene.object_of_region[scene.labels]
        dis = pair_disagreement(pred, gt)
        log_fn(f"[eval] held-out seed {seed}: {scene_kw['n_regions']} "
               f"regions -> {merged.num_clusters} objects (gt "
               f"{scene_kw['n_objects']}), pair disagreement "
               f"{dis * 100:.2f}%")
        results.append({
            "seed": seed,
            "clusters": merged.num_clusters,
            "gt_objects": scene_kw["n_objects"],
            "pair_disagreement": round(dis, 6),
        })
    return threshold, calibration, results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true",
                   help="flagship EVAL.md settings (100 epochs, 1024^2 scenes)")
    p.add_argument("--size", type=int, default=None, help="scene side (px)")
    p.add_argument("--regions", type=int, default=None)
    p.add_argument("--objects", type=int, default=None)
    p.add_argument("--points", type=int, default=None, help="points/region")
    p.add_argument("--noise", type=float, default=10.0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--train-seed", type=int, default=0)
    p.add_argument("--test-seeds", type=int, nargs="+", default=[7, 8, 9])
    p.add_argument("--threshold", type=float, default=1.0,
                   help="merge distance threshold (= train margin)")
    p.add_argument("--calibrate", action="store_true",
                   help="pick the threshold on a labeled validation scene "
                   "(seed train_seed+500) instead of hand-setting it")
    p.add_argument("--val-seed", type=int, default=None,
                   help="validation scene seed for --calibrate")
    p.add_argument("--checkpoint-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "deepmerge_eval_ckpt"))
    p.add_argument("--resume", action="store_true",
                   help="resume training from the checkpoint dir")
    p.add_argument("--serve-only", action="store_true",
                   help="skip training: restore the checkpoint dir's final "
                   "checkpoint (the port's own, train/checkpoint.py) and run "
                   "the serving half (calibration + held-out merges)")
    p.add_argument("--variant", default="v3",
                   help="model variant to train+serve (v1-v6; v4/v5 carry "
                   "aux heads usable with --aux-weights)")
    p.add_argument("--aux-weights", type=float, nargs=2, default=None,
                   metavar=("W1", "W2"),
                   help="v4/v5 deep-supervision loss weights (the "
                   "reference's commented-out sum uses 0.1 0.2, "
                   "Train_SMT.py:285-288)")
    p.add_argument("--quantize",
                   choices=["", "w8a8", "w8a8+attn", "w8a8-static",
                            "w8a8-static+attn"],
                   default="",
                   help="serve the held-out scenes with the quantized "
                   "(w8a8) inference path; training stays bf16. Static "
                   "modes calibrate activation scales on the extractor's "
                   "first batch")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card (default) or, with the kernels' "
                   "plain versions, on the CPU")
    args = p.parse_args(argv)

    if args.full:
        size = args.size if args.size is not None else 1024
        regions = args.regions if args.regions is not None else 2048
        objects = args.objects if args.objects is not None else 96
        points = args.points if args.points is not None else 3
        epochs = args.epochs if args.epochs is not None else 100
        model_over = {}
    else:
        size = args.size if args.size is not None else 256
        regions = args.regions if args.regions is not None else 192
        objects = args.objects if args.objects is not None else 16
        points = args.points if args.points is not None else 3
        epochs = args.epochs if args.epochs is not None else 3
        # small-but-real model so the smoke run finishes in minutes anywhere
        model_over = dict(embed_dim=128, num_heads=4, depth=(2, 1, 1))

    from deepmerge_tpu_torch.config import Config, ModelConfig, TrainConfig
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.models.s2former import build_model
    from deepmerge_tpu_torch.train.driver import train
    from deepmerge_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Config(
        model=ModelConfig(variant=args.variant, **model_over),
        train=TrainConfig(
            num_epochs=epochs,
            seed=args.train_seed,
            checkpoint_dir=args.checkpoint_dir,
            resume=args.resume,
            aux_weights=(tuple(args.aux_weights)
                         if args.aux_weights else (0.0, 0.0)),
        ),
    )
    # the config refuses what the JAX package's refuses (w8a8-static+attn)
    # before any training
    infer_mcfg = dataclasses.replace(cfg.model, quantize=args.quantize)
    print(f"[eval] model={cfg.model.name} epochs={epochs} "
          f"scene={size}x{size} regions={regions} objects={objects} "
          f"device={device}")

    scene_kw = dict(h=size, w=size, n_regions=regions, n_objects=objects,
                    points_per_region=points, noise=args.noise)

    if args.serve_only:
        from deepmerge_tpu_torch.train.checkpoint import CheckpointManager
        from deepmerge_tpu_torch.train.loop import create_train_state

        state = create_train_state(cfg, device=device)
        state, ep, _ = CheckpointManager(
            args.checkpoint_dir, cfg).restore(state)
        t_train, final_loss = 0.0, float("nan")
        print(f"[eval] serve-only: restored {args.checkpoint_dir} "
              f"(through epoch {ep})")
    else:
        train_scene = generate_scene(seed=args.train_seed, **scene_kw)
        t0 = time.time()
        state, history = train(cfg, scene=train_scene, device=device)
        t_train = time.time() - t0
        final_loss = (history.train_losses[-1] if history.train_losses
                      else float("nan"))
        print(f"[eval] trained {epochs} epochs in {t_train:.1f}s, "
              f"final loss {final_loss:.5f}")

    model = build_model(infer_mcfg)
    model.load_state_dict(state.model.state_dict(), strict=True)
    val_seed = (args.val_seed if args.val_seed is not None
                else args.train_seed + 500)
    threshold, calibration, results = serve_held_out(
        cfg, model, scene_kw, args.test_seeds, threshold=args.threshold,
        calibrate=args.calibrate, val_seed=val_seed, device=device)

    print(json.dumps({
        "config": dataclasses.asdict(infer_mcfg),
        "epochs": epochs,
        "train_seconds": round(t_train, 1),
        "final_loss": round(float(final_loss), 6),
        "threshold": round(float(threshold), 6),
        "calibration": calibration,
        "held_out": results,
        "device": str(device),
    }))


if __name__ == "__main__":
    main()
