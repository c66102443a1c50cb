"""End-to-end benchmark of the PyTorch port: megapixels per second segmented
and merged on one card (port of the repository's root ``bench.py``).

    python -m deepmerge_tpu_torch.bench                  # the headline
    BENCH_SERVE=4 python -m deepmerge_tpu_torch.bench    # the serving walk
    BENCH_TRAIN=3 python -m deepmerge_tpu_torch.bench    # training
    BENCH_MESH=1 python -m deepmerge_tpu_torch.bench     # the mesh, one card
    BENCH_MESH=4 torchrun --nproc_per_node=4 -m deepmerge_tpu_torch.bench

The pipeline of the headline: synthetic scene → multi-scale patches (K1) →
S2Former-v3 embeddings of every region sample point (w8a8 by default: K4)
→ region pooling → RAG edge scoring → merge rounds → merged (H, W) label
map (K9), through ``FeatureExtractor.segment_scene_device`` on a staged
scene. Every mode runs on the card and raises without one; the mesh runs
gloo ranks on the CPU only when the caller sets ``BENCH_MESH_PLATFORM=cpu``.

Knobs (the root script's, with its defaults):

- ``BENCH_SCENE`` side of the square scene (2048; the mesh's strip height,
  512 on the CPU); ``BENCH_DENSITY`` regions per MPix (8192/4.194304);
  ``BENCH_BATCH`` points a chunk (2048) or pairs a training step (120);
  ``BENCH_MODEL`` the variant (v3; ``vit`` runs at its fixed patch sizes
  28/56/112/224, which the root script does not set, so that there it
  stops in ``build_model``);
- ``BENCH_QUANT`` unset or 1 → w8a8, 0 → bf16, otherwise used as
  ``model.quantize``; ``BENCH_CHAIN`` 0 unchains the stages, 2 chains
  stage 0 too; ``BENCH_BT`` sets ``model.fused_block_bt``, the TPU
  kernel's batch tile, which does nothing here;
- ``BENCH_STREAM=N`` (> 1) the streamed-strip extraction, then the merge
  and the map as separate calls; ``BENCH_FUSED_MAP=0`` the merge, a host
  read, then the map as a separate call;
- ``BENCH_RUNS`` timed runs after a warm-up (5; the mesh 3), their median
  reported; ``BENCH_CURVE=0`` skips the density curve (500, 1000 and 2000
  regions/MPix; skipped too when streaming or with ``BENCH_DENSITY``);
  ``BENCH_VERBOSE`` prints ``[bench]`` lines and a phase attribution on
  stderr;
- the modes: ``BENCH_SERVE=K`` (the ``process_folder`` walk over K
  scenes), ``BENCH_TRAIN=K`` (K scanned epochs, ``BENCH_TRAIN_FUSED=1``
  through the training block K5), ``BENCH_MESH=N`` (weak scaling of
  ``extract_and_merge_sharded`` over the powers of two up to N ranks,
  ``BENCH_MESH_PLATFORM`` ``device``, NCCL with one rank a card, by
  default, or ``cpu``, gloo ranks on the CPU).

Prints ONE JSON line on stdout: ``metric`` and ``value`` as the root
script defines them, ``unit`` per GPU (the mesh: its total), ``device``
(the card's name, or ``cpu``), and the mode's own keys.

Each mode is a function of its workload (the ``Config``, the scene or
folder, the device), so that a caller passes its own; ``main`` reads the
environment and builds the root script's workload.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    MergeConfig,
    ModelConfig,
    TrainConfig,
)
from deepmerge_tpu_torch.utils.device import resolve_device

DEFAULT_DENSITY = 8192 / 4.194304   # regions per MPix: 8192 at 2048²
CURVE_DENSITIES = (500, 1000, 2000)
VIT_SCALES = (28, 56, 112, 224)     # the ScaleEmbedTransformer's patch sizes
EDGE_PAD = 2048                     # the headline's edge-array granularity
MAX_ROUNDS = 8
LINK_MB = 8.0


def _bench_quantize(env=os.environ) -> str:
    """BENCH_QUANT: '0' → bf16, unset/'1' → 'w8a8' (the serving default),
    any other value is ``model.quantize`` as given."""
    v = env.get("BENCH_QUANT", "1")
    return {"0": "", "1": "w8a8"}.get(v, v)


def config_for(mode: str, env=os.environ) -> Config:
    """The ``Config`` the root script builds for ``mode`` (``main``,
    ``serve``, ``train`` or ``mesh``) from the knobs in ``env``."""
    variant = env.get("BENCH_MODEL", "v3")
    vit = variant == "vit"
    scales = dict(input_image_scales=VIT_SCALES) if vit else {}
    patches = dict(patch_sizes=VIT_SCALES) if vit else {}
    if mode == "train":
        return Config(
            model=ModelConfig(dtype="bfloat16", variant=variant, **scales),
            data=DataConfig(max_window=512, batch_size=int(
                env.get("BENCH_BATCH", 120)), **patches),
            train=TrainConfig(fused_block=(
                env.get("BENCH_TRAIN_FUSED", "0") == "1")),
        )
    model = dict(dtype="bfloat16", variant=variant,
                 quantize=_bench_quantize(env), **scales)
    if mode == "main":
        chain = env.get("BENCH_CHAIN", "1")
        model.update(fused_stage_chain=chain != "0",
                     chain_stage0=chain == "2",
                     fused_block_bt=int(env.get("BENCH_BT", 2)))
    return Config(
        model=ModelConfig(**model),
        data=DataConfig(max_window=512, eval_batch_size=int(
            env.get("BENCH_BATCH", 2048)), **patches),
        merge=MergeConfig(engine="device") if mode == "serve"
        else MergeConfig(),
    )


# ------------------------------------------------------------ helpers


def _quiet(*_):
    pass


def make_log(verbose: bool):
    """``[bench +seconds]`` lines on stderr under ``BENCH_VERBOSE``."""
    if not verbose:
        return _quiet
    t_start = time.perf_counter()
    return lambda *a: print(
        f"[bench +{time.perf_counter() - t_start:8.3f}]", *a,
        file=sys.stderr)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fresh_model(mcfg: ModelConfig) -> torch.nn.Module:
    """The model for ``mcfg`` with random weights from seed 0."""
    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.models.s2former import build_model

    model = build_model(mcfg)
    model.load_state_dict(init_state_dict(mcfg, seed=0), strict=True)
    return model


def n_regions_for(h: int, w: int, density: float) -> int:
    return max(int(density * h * w / 1e6), 16)


def make_scene(h: int, w: int, n_regions: int, seed: int = 0, **kw):
    """The benchmark's synthetic scene: one sample point a region, 256
    objects."""
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene

    return generate_scene(h=h, w=w, n_regions=n_regions, n_objects=256,
                          points_per_region=1, seed=seed, **kw)


def train_scene():
    """The training workload's scene (the reference's schedule shape)."""
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene

    return generate_scene(h=1024, w=1024, n_regions=2048, n_objects=64,
                          points_per_region=3, seed=0)


def median_s(fn, runs: int):
    """``(median, times)`` of ``runs`` (at least one) host-clocked calls."""
    times = []
    for _ in range(max(1, runs)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


# ---------------------------------------------------------- the headline


@dataclass
class StagedScene:
    """A scene staged once for the headline's runs: the tile on the device
    (not when streaming), the edges padded to ``EDGE_PAD`` with their
    validity mask, each point's region and the superpixel map."""

    scene: object
    device_scene: object
    edges: torch.Tensor
    edge_valid: torch.Tensor
    point_region: torch.Tensor
    region_map: torch.Tensor


def prep_scene(scene, dcfg: DataConfig, device, stage: bool = True
               ) -> StagedScene:
    from deepmerge_tpu_torch.train.sampler import stage_scene

    dev = torch.device(device)
    edges = scene.rag.edges.astype(np.int32)
    pad = (-len(edges)) % EDGE_PAD
    edge_valid = np.ones(len(edges), bool)
    if pad:
        edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
        edge_valid = np.concatenate([edge_valid, np.zeros(pad, bool)])
    return StagedScene(
        scene=scene,
        device_scene=stage_scene(scene, dcfg, dev) if stage else None,
        edges=torch.from_numpy(edges).to(dev),
        edge_valid=torch.from_numpy(edge_valid).to(dev),
        point_region=torch.from_numpy(np.asarray(
            scene.regions.point_region, np.int32)).to(dev),
        region_map=torch.from_numpy(np.asarray(scene.labels,
                                               np.int32)).to(dev),
    )


def run_scene(extractor, dcfg: DataConfig, st: StagedScene, stream: int = 0,
              fused_map: bool = True, threshold=None) -> dict:
    """One run of the headline's route; ends with a host read of the
    rounds and the cluster count, then a device synchronize. The merged
    (H, W) map stays on the device. ``threshold`` None merges below the
    median edge distance, as the root script does."""
    from deepmerge_tpu_torch.ops.labelprop import (
        device_score_and_merge,
        merged_label_map,
    )

    scene = st.scene
    r = scene.regions.num_regions
    if stream > 1:
        emb = extractor.extract_scene_streamed(scene, dcfg, n_strips=stream)
        simi, labels, rounds = device_score_and_merge(
            torch.from_numpy(emb).to(extractor.device), st.point_region,
            st.edges, st.edge_valid, num_regions=r, max_rounds=MAX_ROUNDS,
            threshold=threshold)
        label_map, n_clusters = merged_label_map(labels, st.region_map)
    elif fused_map:
        simi, labels, rounds, label_map, n_clusters = (
            extractor.segment_scene_device(
                scene, dcfg, st.edges, st.edge_valid, num_regions=r,
                max_rounds=MAX_ROUNDS, device_scene=st.device_scene,
                region_map=st.region_map, threshold=threshold))
    else:
        simi, labels, rounds = extractor.segment_scene_device(
            scene, dcfg, st.edges, st.edge_valid, num_regions=r,
            max_rounds=MAX_ROUNDS, device_scene=st.device_scene,
            threshold=threshold)
        rounds = int(rounds)  # the merge's host read before the map
        # labels ride the bucketed region axis; num_real keeps the
        # cluster count exact
        label_map, n_clusters = merged_label_map(labels, st.region_map, r)
    out = dict(simi=simi, labels=labels, rounds=int(rounds),
               label_map=label_map, n_clusters=int(n_clusters))
    _sync(extractor.device)
    return out


def _attribution(extractor, dcfg, st: StagedScene, log) -> None:
    """The phases of one run as separate calls, each to a host read (not
    the timed path), and the map's device time by ``rep_probe``."""
    from deepmerge_tpu_torch.ops.labelprop import (
        device_score_and_merge,
        merged_label_map,
    )
    from deepmerge_tpu_torch.utils.profiling import rep_probe

    r = st.scene.regions.num_regions
    names = ("extract", "score+merge", "labelmap")
    phases = dict.fromkeys(names, 0.0)

    def once():
        t = [time.perf_counter()]
        emb = extractor.extract_scene_device(st.scene, dcfg,
                                             device_scene=st.device_scene)
        float(emb.abs().sum())
        t.append(time.perf_counter())
        _, labels, rounds = device_score_and_merge(
            emb, st.point_region, st.edges, st.edge_valid, num_regions=r,
            max_rounds=MAX_ROUNDS)
        int(rounds)
        t.append(time.perf_counter())
        _, n = merged_label_map(labels, st.region_map)
        int(n)
        t.append(time.perf_counter())
        for name, a, b in zip(names, t, t[1:]):
            phases[name] += b - a

    once()  # warm-up
    phases.update(dict.fromkeys(names, 0.0))
    att_runs = 2
    for _ in range(att_runs):
        once()

    def lm_body(i, labels, rm):
        lab = torch.clamp(labels + (i % 3), max=r - 1)
        m, n = merged_label_map(lab, rm, r)
        return m[0, 0].to(torch.float32) + n.to(torch.float32)

    lm0 = torch.arange(r, dtype=torch.int32, device=extractor.device)
    phases["labelmap(device)"] = rep_probe(
        lm_body, lm0, st.region_map, k=8) * att_runs / 1000.0
    detail = ", ".join(f"{k}={v / att_runs * 1000:.1f}ms"
                       for k, v in phases.items())
    log(f"phase attribution (separate calls, mean of {att_runs}; each ends "
        f"in a host read the timed path does not pay; labelmap(device) is "
        f"the rep-probed device time): {detail}")


def segment_and_merge_bench(cfg: Config, scene, *, device="cuda",
                            model=None, runs: int = 5, stream: int = 0,
                            fused_map: bool = True, curve=None,
                            threshold=None, log=_quiet):
    """The headline: megapixels of ``scene`` segmented and merged per
    second, the median of ``runs`` host-clocked runs after a warm-up, on
    one of three routes (``run_scene``). ``model`` defaults to
    ``cfg.model`` with random weights from seed 0; ``curve`` maps regions
    per MPix to a scene of the same size, each timed as the median of
    three runs. With a ``log`` (``BENCH_VERBOSE``) a phase attribution
    follows the timed runs. Returns the JSON line's dict and the last
    run's outputs."""
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor

    dev = resolve_device(device)
    dcfg = cfg.data
    extractor = FeatureExtractor(model if model is not None
                                 else fresh_model(cfg.model),
                                 batch_size=dcfg.eval_batch_size, device=dev)
    st = prep_scene(scene, dcfg, dev, stage=stream <= 1)

    def run(s):
        return run_scene(extractor, dcfg, s, stream=stream,
                         fused_map=fused_map, threshold=threshold)

    run(st)  # warm-up
    result = {}
    dt, times = median_s(lambda: result.update(run(st)), runs)
    if stream > 1:
        log("BENCH_STREAM>1: no phase attribution (its separate calls "
            "would stage the whole scene)")
    elif log is not _quiet:
        _attribution(extractor, dcfg, st, log)
    log(f"run times: {[round(x, 4) for x in times]} -> median {dt:.4f}s")

    h, w = scene.image.shape[:2]
    mpix = h * w / 1e6
    out = {
        "metric": "end_to_end_segment_and_merge_throughput",
        "value": round(mpix / dt, 4),
        "unit": "megapixels/sec/gpu",
    }
    points = {}
    for dens, cscene in (curve or {}).items():
        cst = prep_scene(cscene, dcfg, dev)
        run(cst)  # warm-up
        cdt, ctimes = median_s(lambda: run(cst), 3)
        points[str(dens)] = round(mpix / cdt, 4)
        log(f"density {dens}/MPix: {points[str(dens)]} MPix/s/gpu "
            f"({[round(x, 4) for x in ctimes]})")
        del cst
    if points:
        out["density_curve"] = points
        out["density_curve_unit"] = "megapixels/sec/gpu at N regions/MPix"
    out["device"] = device_name(dev)
    return out, result


# ------------------------------------------------------- serving walk


def export_scene_folder(scene, root: str) -> tuple[str, str]:
    """Write ``scene`` into the reference folder layout under ``root``:
    ``images/<name>.tif``, ``shps/<name>.shp`` and
    ``shps/<name>/{PointsGCS,lines}.shp``. Returns the image and
    shapefile folders."""
    from deepmerge_tpu_torch.geodata.ingest import export_scene

    images = os.path.join(root, "images")
    shps = os.path.join(root, "shps")
    stage = os.path.join(root, "stage")
    os.makedirs(images, exist_ok=True)
    os.makedirs(os.path.join(shps, scene.name), exist_ok=True)
    paths = export_scene(scene, stage, compression="deflate")
    os.rename(paths["image"], os.path.join(images, f"{scene.name}.tif"))
    for ext in (".shp", ".shx", ".dbf"):
        os.rename(os.path.join(stage, f"{scene.name}{ext}"),
                  os.path.join(shps, f"{scene.name}{ext}"))
        for base in ("PointsGCS", "lines"):
            src = os.path.join(stage, scene.name, f"{base}{ext}")
            if os.path.exists(src):
                os.rename(src, os.path.join(shps, scene.name,
                                            f"{base}{ext}"))
    return images, shps


def link_h2d_mbps(dev: torch.device) -> float:
    """Host → device rate of an 8 MB pageable upload ended by a scalar
    read, MB/s (the better of two)."""
    x = np.random.default_rng(0).integers(0, 255, (int(LINK_MB * 2**20),),
                                          np.uint8)
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        d = torch.from_numpy(x).to(dev)
        float(d[:: 2**18].to(torch.float32).abs().sum())
        rates.append(LINK_MB / (time.perf_counter() - t0))
        del d
        x = x ^ np.uint8(1)
    return round(max(rates), 2)


def serve_bench(cfg: Config, images: str, shps: str, n_scenes: int,
                scene_shape, *, device="cuda", log=_quiet):
    """Folder-serving throughput: ``process_folder`` over the ``n_scenes``
    scenes of ``scene_shape`` in ``images``/``shps`` (ingest, staging,
    extraction, scoring, merge, the ``simi`` write-back and each scene's
    store) with one warm extractor from ``load_params``: one walk to warm
    up, then a timed walk. The store is each scene's .h5, or in memory
    where h5py is missing (``store`` says which). Returns the JSON line's
    dict and the scenes done."""
    from deepmerge_tpu_torch.infer import extract
    from deepmerge_tpu_torch.infer.driver import load_params, process_folder

    dev = resolve_device(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fresh weights are the point here
        model = load_params(cfg)
    ex = extract.FeatureExtractor(model, batch_size=cfg.data.eval_batch_size,
                                  device=dev)
    stats = {}
    stores = None if extract.HAS_H5PY else {}
    done = process_folder(cfg, images, shps, log_fn=log, extractor=ex,
                          stores=stores, device=dev)
    if len(done) != n_scenes:
        raise RuntimeError(f"warm-up walk: {len(done)}/{n_scenes} "
                           "scenes done")
    t0 = time.perf_counter()
    done = process_folder(cfg, images, shps, log_fn=log, extractor=ex,
                          stats=stats, stores=stores, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    if len(done) != n_scenes:
        raise RuntimeError(f"timed walk: {len(done)}/{n_scenes} scenes done")
    link = link_h2d_mbps(dev)
    # the steady rate: the median gap between completions once the
    # pipeline is full (the first completion carries the fill)
    ts = stats.get("scene_done_ts", [])
    deltas = [b - a for a, b in zip(ts, ts[1:])]
    h, w = scene_shape
    mpix = n_scenes * h * w / 1e6
    log(f"serve: {n_scenes} scenes in {dt:.3f}s ({dt / n_scenes:.3f}s/scene "
        f"with ingest, staging and write-back); H2D {link} MB/s "
        f"({h * w * 3 / 1e6:.1f} MB tile upload a scene)")
    out = {
        "metric": "folder_serving_throughput",
        "value": round(mpix / dt, 4),
        "unit": "megapixels/sec/gpu",
        "link_h2d_mbps": link,
    }
    if deltas:
        steady = float(np.median(deltas))
        out["steady_scene_seconds"] = round(steady, 3)
        out["steady_mpix_per_s"] = round(h * w / 1e6 / steady, 4)
    out["device"] = device_name(dev)
    out["store"] = "h5" if stores is None else "memory"
    return out, done


# ----------------------------------------------------------- training


def train_bench(cfg: Config, scene, epochs: int, *, device="cuda",
                log=_quiet):
    """Training throughput, pairs/s over ``epochs`` scanned epochs of
    ``FusedPairSampler`` batches on ``scene`` after a warm-up epoch;
    epoch k+1 is dispatched before epoch k's losses are read. Returns the
    JSON line's dict and the last epoch's losses."""
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs
    from deepmerge_tpu_torch.train.loop import (
        create_train_state,
        make_scanned_epoch,
    )
    from deepmerge_tpu_torch.train.sampler import FusedPairSampler

    dev = resolve_device(device)
    bs = cfg.data.batch_size
    pos, neg = make_training_pairs(scene)
    sampler = FusedPairSampler(scene, pos, neg, cfg.data, dev)
    steps = max(len(sampler) // bs, 1)
    state = create_train_state(cfg, steps, device=dev)
    epoch_fn = make_scanned_epoch(cfg, sampler.device_scene)

    state, losses = epoch_fn(state, *sampler.epoch_arrays(0, bs))  # warm-up
    float(losses.sum())
    t0 = time.perf_counter()
    total_pairs = n_steps = 0
    pending = None
    for e in range(1, epochs + 1):
        arrays = sampler.epoch_arrays(e, bs)
        state, losses = epoch_fn(state, *arrays)
        if pending is not None:
            float(pending.sum())
        pending = losses
        n_steps = arrays[0].shape[0]
        total_pairs += n_steps * bs
    float(pending.sum())
    _sync(dev)
    dt = time.perf_counter() - t0
    log(f"train: {epochs} epochs x {n_steps} steps (batch {bs}) in "
        f"{dt:.3f}s = {dt / epochs:.3f}s/epoch, "
        f"{dt / epochs / n_steps * 1000:.1f}ms/step")
    return {
        "metric": "training_throughput",
        "value": round(total_pairs / dt, 1),
        "unit": "pairs/sec/gpu",
        "device": device_name(dev),
    }, pending.cpu().numpy()


# --------------------------------------------------------------- mesh


def mesh_bench(cfg: Config, n: int, scene_for, *, device="cuda",
               model=None, runs: int = 3, threshold: float = 1.0,
               log=_quiet):
    """Weak scaling of ``extract_and_merge_sharded`` over a mesh of k
    ranks for every power of two k up to ``n``: ``scene_for(k)`` is a
    mosaic k strips wide, so each rank's work is constant and the ideal is
    flat time. Every rank of the process group (at least ``n``) calls it;
    at each point the ranks past k wait at a barrier, and the point's group
    is destroyed after it. ``threshold`` is the merge's (the root
    script's 1.0). Returns, on rank 0,
    the JSON line's dict (else None), and this rank's ``MergeResult`` at
    each point it took part in."""
    import torch.distributed as dist

    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.parallel.distributed import (
        extract_and_merge_sharded,
    )
    from deepmerge_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"BENCH_MESH={n} needs {n} ranks, the process "
                         f"group has {world}")
    model = model if model is not None else fresh_model(cfg.model)
    points = [1]
    while points[-1] * 2 <= n:
        points.append(points[-1] * 2)
    times, merged = {}, {}
    for k in points:
        mesh = make_mesh(n_data=k, devices=dev, ranks=range(k))
        if mesh is not None:
            scene = scene_for(k)
            ex = FeatureExtractor(model, batch_size=cfg.data.eval_batch_size,
                                  mesh=mesh)

            def run():
                res = extract_and_merge_sharded(
                    None, scene, cfg.data, mesh, threshold=threshold,
                    max_rounds=MAX_ROUNDS, extractor=ex)
                _sync(dev)
                return res

            res = run()  # warm-up
            if res.num_clusters < 1:
                raise RuntimeError(f"mesh {k}x1: no cluster")
            dt, ts = median_s(run, runs)
            h, w = scene.image.shape[:2]
            times[k] = (dt, h * w / 1e6)
            merged[k] = res
            log(f"mesh {k}x1: {h}x{w} scene, {[round(x, 3) for x in ts]} "
                f"-> median {dt:.3f}s ({h * w / 1e6 / dt:.3f} MPix/s)")
            del ex, scene
        dist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)
        if mesh is not None:
            dist.destroy_process_group(mesh.data_group)
    if dist.get_rank() != 0:
        return None, merged
    t1 = times[1][0]
    tn, mpix = times[n]
    out = {
        "metric": "mesh_segment_and_merge_throughput",
        "value": round(mpix / tn, 4),
        "unit": "megapixels/sec",
        "mesh_devices": n,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "per_device_mpix_s": round(mpix / tn / n, 4),
        "weak_scaling_efficiency": round(t1 / tn, 4),
        "points": {
            str(k): {"seconds": round(t, 3), "mpix": round(m, 3),
                     "corrected_eff": round(k * t1 / t, 4)}
            for k, (t, m) in times.items()
        },
    }
    if dev.type == "cpu":
        # the ranks share this host's cores: the ideal time is n * t1
        out["host_cores"] = os.cpu_count() or 1
        out["cpu_serialized_efficiency"] = round(n * t1 / tn, 4)
    out["device"] = device_name(dev)
    return out, merged


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_main(env, log):
    """``BENCH_MESH=N``: one process a rank under torchrun (N = 1 also
    without it), NCCL on the cards, or gloo on the CPU under
    ``BENCH_MESH_PLATFORM=cpu``."""
    import torch.distributed as dist

    from deepmerge_tpu_torch.parallel.distributed import initialize

    n = int(env["BENCH_MESH"])
    on_card = env.get("BENCH_MESH_PLATFORM", "device") != "cpu"
    device = (resolve_device(f"cuda:{int(env.get('LOCAL_RANK', 0))}")
              if on_card else torch.device("cpu"))
    if int(env.get("WORLD_SIZE", 1)) > 1:
        initialize(device=device)
    elif n > 1:
        raise ValueError(f"BENCH_MESH={n} runs one process a rank: "
                         f"torchrun --nproc_per_node={n} -m "
                         "deepmerge_tpu_torch.bench")
    else:
        if on_card:
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", world_size=1,
            rank=0)
    try:
        side = int(env.get("BENCH_SCENE", 2048 if on_card else 512))
        density = float(env.get("BENCH_DENSITY", DEFAULT_DENSITY))

        def scene_for(k):
            return make_scene(side, side * k,
                              n_regions_for(side, side * k, density))

        out, _ = mesh_bench(config_for("mesh", env), n, scene_for,
                            device=device, runs=int(env.get("BENCH_RUNS", 3)),
                            log=log)
    finally:
        dist.destroy_process_group()
    return out


def main(env=None):
    """Read the knobs from ``env`` (default ``os.environ``), run the mode
    they select and print its one JSON line (on rank 0 of a mesh)."""
    env = os.environ if env is None else env
    log = make_log(bool(env.get("BENCH_VERBOSE")))
    if int(env.get("BENCH_MESH", "0")) <= 0:
        resolve_device("cuda")  # before any scene is made
    if "BENCH_BT" in env:
        log(f"BENCH_BT={env['BENCH_BT']} sets model.fused_block_bt, the TPU "
            "kernel's batch tile: no effect on this device")
    side = int(env.get("BENCH_SCENE", 2048))
    density = float(env.get("BENCH_DENSITY", DEFAULT_DENSITY))
    n_regions = n_regions_for(side, side, density)
    if int(env.get("BENCH_MESH", "0")) > 0:
        out = _mesh_main(env, log)
    elif int(env.get("BENCH_SERVE", "0")) > 0:
        import tempfile

        k = int(env["BENCH_SERVE"])
        with tempfile.TemporaryDirectory() as root:
            for seed in range(1, k + 1):
                images, shps = export_scene_folder(
                    make_scene(side, side, n_regions, seed=seed,
                               name=f"scene{seed}"), root)
            out, _ = serve_bench(config_for("serve", env), images, shps, k,
                                 (side, side), log=log)
    elif int(env.get("BENCH_TRAIN", "0")) > 0:
        out, _ = train_bench(config_for("train", env), train_scene(),
                             int(env["BENCH_TRAIN"]), log=log)
    else:
        stream = int(env.get("BENCH_STREAM", "0"))
        curve = None
        if (env.get("BENCH_CURVE", "1") != "0" and stream <= 1
                and "BENCH_DENSITY" not in env):
            curve = {d: make_scene(side, side, n_regions_for(side, side, d))
                     for d in CURVE_DENSITIES}
        out, _ = segment_and_merge_bench(
            config_for("main", env), make_scene(side, side, n_regions),
            runs=int(env.get("BENCH_RUNS", 5)), stream=stream,
            fused_map=env.get("BENCH_FUSED_MAP", "1") != "0", curve=curve,
            log=log)
    if out is not None:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
