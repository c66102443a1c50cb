"""Inference drivers (port of ``deepmerge_tpu/infer/driver.py``): one scene
extracted, scored and merged, and the walk over a folder of scenes in the
reference's file layout.

Streams: the walk keeps every upload and every kernel on the device's
current stream, whichever thread enqueues it. A scene staged on the prefetch
thread has its uploads enqueued before the walk's thread receives it, so
the kernels that read it are ordered after them. The finalize thread pulls
a scene's outputs on a side stream that first waits on an event recorded
right after the scene's work, so that the pull neither reads early nor
waits for the next scene.
"""

from __future__ import annotations

import os
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from deepmerge_tpu_torch.config import Config
from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.utils.profiling import Timings, phase_timer
from deepmerge_tpu_torch.infer.extract import (
    FeatureExtractor,
    FeatureStore,
    region_bucket,
    unpack_serve_tail,
)
from deepmerge_tpu_torch.infer.merge import (
    MergeResult,
    labels_to_result,
    merge_scene,
    merge_scene_device,
    padded_edges,
    write_label_geotiff,
)
from deepmerge_tpu_torch.infer.scoring import score_scene_edges
from deepmerge_tpu_torch.utils.device import resolve_device

def load_params(cfg: Config, checkpoint_path: Optional[str] = None):
    """The port's model for ``cfg.model`` (``build_model``): the weights of
    a reference ``.pth``, or fresh random ones from seed 0 when no
    checkpoint is given (with a warning). A ``.msgpack`` or orbax
    checkpoint of the JAX package is converted first with ``python -m
    deepmerge_tpu export-ckpt``."""
    from deepmerge_tpu_torch.compat.weights import (
        init_state_dict,
        load_reference_checkpoint,
    )
    from deepmerge_tpu_torch.models.s2former import build_model

    if not checkpoint_path:
        warnings.warn(
            "load_params: no checkpoint_path given — using FRESH random "
            "parameters (embeddings will be untrained)",
            stacklevel=2,
        )
        model = build_model(cfg.model)
        model.load_state_dict(init_state_dict(cfg.model, seed=0), strict=True)
        return model
    if checkpoint_path.endswith(".pth"):
        return load_reference_checkpoint(checkpoint_path, cfg.model)
    raise ValueError(
        f"{checkpoint_path}: the PyTorch port reads reference .pth "
        "checkpoints; convert a .msgpack or orbax checkpoint first with "
        "`python -m deepmerge_tpu export-ckpt <ckpt> <out.pth>`"
    )


def _staged_edge_arrays(scene: Scene, edge_batch: int, ds=None,
                        device: torch.device | str = "cuda"):
    """The padded RAG edge arrays on ``device``, cached on the staged scene
    so that the prefetch thread can upload them ahead of the scene."""
    cache = ds.__dict__.setdefault("_edge_arrays_cache", {}) \
        if ds is not None else {}
    if edge_batch not in cache:
        edges, valid = padded_edges(scene, edge_batch)
        device = resolve_device(device)
        cache[edge_batch] = (torch.from_numpy(edges).to(device),
                             torch.from_numpy(valid).to(device))
    return cache[edge_batch]


def prestage_scene(extractor: FeatureExtractor, scene: Scene, ds, data_cfg,
                   edge_batch: int) -> None:
    """Warm every per-scene input cache from the prefetch thread: the
    chunked point inputs, the padded point→region ids and the padded edge
    arrays, so that dispatching the scene uploads nothing."""
    _, _, args = extractor._chunked_inputs(ds, data_cfg)
    total = args[0].shape[0] * args[0].shape[1]
    extractor._padded_point_region(
        ds, region_bucket(scene.regions.num_regions), total)
    _staged_edge_arrays(scene, edge_batch, ds=ds, device=extractor.device)


def _record(device: torch.device):
    """An event after the work enqueued so far on ``device``'s current
    stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _pull(event, *tensors) -> list[torch.Tensor]:
    """The tensors on the host, copied once ``event`` has completed, on a
    side stream of their device (plain copies on the CPU)."""
    if event is None:
        return [t.cpu() for t in tensors]
    dev = tensors[0].device
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        torch.cuda.current_stream(dev).wait_event(event)
        return [t.to("cpu") for t in tensors]


def process_scene(
    cfg: Config,
    scene: Scene,
    model=None,
    store: Optional[FeatureStore] = None,
    lines_path: Optional[str] = None,
    do_merge: bool = True,
    timings: Optional[Timings] = None,
    log_fn=print,
    extractor: Optional[FeatureExtractor] = None,
    mesh=None,
    stream_tiles: Optional[int] = None,
    device_scene=None,
    fused: Optional[bool] = None,
    finalize_executor=None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray, Optional[MergeResult]]:
    """Extract → score → (merge) one scene.

    Returns ``(point_embeddings, edge_simi, merge_result)``; with ``store``
    (a ``FeatureStore``: the reference's per-scene .h5, or in memory) the
    embeddings are also appended there and the store closed, and with
    ``lines_path`` the distances go into lines.shp's ``simi`` field.
    ``model`` is a port backbone (default: ``load_params(cfg)``);
    ``extractor`` lets a walk reuse one ``FeatureExtractor`` (its
    ``device`` then wins over ``device``). ``stream_tiles`` extracts
    through N column strips (``extract_scene_streamed``), with the same
    embeddings. ``device_scene`` is an already staged scene. ``fused``
    forces the serving path (``segment_scene_device(serve_packed=True)``,
    on by default for the device merge) on or off. With
    ``finalize_executor`` (one worker) the host tail — the pulls, the .h5,
    the ``simi`` write — runs there and the call returns a ``Future`` of
    the usual tuple.

    ``mesh`` (``parallel.make_mesh``; every rank of the mesh calls this
    with the same scene) splits each chunk of points over the mesh's data
    axis (a mesh ``FeatureExtractor``) and, with the device engine, merges
    with the collective rounds of ``parallel.distributed.distributed_merge``:
    the partition of one device. The fused path is off. Every rank returns
    the result; rank 0 alone writes ``store`` and the ``simi`` field.
    """
    if extractor is None:
        if model is None:
            model = load_params(cfg)
        extractor = FeatureExtractor(
            model, batch_size=cfg.data.eval_batch_size, device=device,
            mesh=mesh)
    timings = timings or Timings()
    if mesh is not None and mesh.rank != 0:
        store, lines_path = None, None  # rank 0 alone writes

    fused = (
        (True if fused is None else fused)
        and mesh is None
        and (stream_tiles is None or stream_tiles <= 1)
        and do_merge
        and cfg.merge.engine == "device"
        and scene.regions.num_points > 0
    )
    if fused:
        edges_dev, valid_dev = _staged_edge_arrays(
            scene, max(cfg.merge.edge_batch, 1), ds=device_scene,
            device=extractor.device)
        q = cfg.merge.threshold_quantile
        emb_dev, tail_dev = extractor.segment_scene_device(
            scene, cfg.data, edges_dev, valid_dev,
            num_regions=scene.regions.num_regions,
            max_rounds=cfg.merge.max_rounds,
            device_scene=device_scene,
            threshold=None if q is not None else cfg.merge.threshold,
            threshold_quantile=q if q is not None else 0.5,
            serve_packed=True,
        )
        scene_done = _record(extractor.device)
        n_edges_padded = int(edges_dev.shape[0])
        n_points = scene.regions.num_points

        def finalize():
            with phase_timer(timings, "pull"):
                tail, emb = _pull(scene_done, tail_dev, emb_dev)
                emb = emb.to(torch.float32).numpy()[:n_points]
            simi, labels, rounds = unpack_serve_tail(
                tail, n_edges_padded, scene.rag.num_edges,
                scene.regions.num_regions)
            scene.rag.simi = simi
            if store is not None:
                with phase_timer(timings, "h5"):
                    store.append(emb)
                    store.close()
            if lines_path and os.path.exists(lines_path):
                from deepmerge_tpu_torch.geodata.ingest import write_simi

                with phase_timer(timings, "simi"):
                    write_simi(lines_path, simi)
            sweeps_run = min(rounds + 1, cfg.merge.max_rounds)
            result = labels_to_result(
                labels, rounds, edges_scored=sweeps_run * scene.rag.num_edges)
            log_fn(
                f"{scene.name}: {scene.regions.num_regions} regions -> "
                f"{result.num_clusters} objects in {result.rounds} rounds "
                f"({timings.summary()})"
            )
            return emb, simi, result

        if finalize_executor is not None:
            return finalize_executor.submit(finalize)
        return finalize()

    emb_dev = None  # the embeddings on the device, where the path has them
    try:
        with phase_timer(timings, "extract"):
            if stream_tiles is not None and stream_tiles > 1:
                emb = extractor.extract_scene_streamed(
                    scene, cfg.data, n_strips=stream_tiles, store=store)
            else:
                # one pull for the store and the return value; scoring and
                # the device merge read the device copy
                emb_dev = extractor.extract_scene_device(
                    scene, cfg.data, device_scene=device_scene)
                emb = emb_dev.cpu().numpy()
                if store is not None:
                    store.append(emb)
    finally:
        if store is not None:
            store.close()
    on_device = emb if emb_dev is None else emb_dev

    with phase_timer(timings, "score"):
        simi = score_scene_edges(scene, on_device, cfg.merge.edge_batch)
    if lines_path and os.path.exists(lines_path):
        from deepmerge_tpu_torch.geodata.ingest import write_simi

        write_simi(lines_path, simi)

    result = None
    if do_merge:
        thr = cfg.merge.threshold
        if cfg.merge.threshold_quantile is not None and len(simi):
            # method='lower' is the device path's floor-index quantile
            thr = float(np.quantile(simi, cfg.merge.threshold_quantile,
                                    method="lower"))
        with phase_timer(timings, "merge"):
            if mesh is not None and cfg.merge.engine == "device":
                from deepmerge_tpu_torch.parallel.distributed import (
                    distributed_merge,
                )

                labels, rounds = distributed_merge(
                    on_device, scene.regions.point_region,
                    scene.regions.num_regions, scene.rag.edges, mesh,
                    threshold=thr, max_rounds=cfg.merge.max_rounds)
                result = labels_to_result(labels, rounds, scene)
            elif cfg.merge.engine == "device":
                result = merge_scene_device(scene, on_device, threshold=thr,
                                            max_rounds=cfg.merge.max_rounds)
            else:
                result = merge_scene(scene, emb, threshold=thr,
                                     max_rounds=cfg.merge.max_rounds,
                                     edge_batch=cfg.merge.edge_batch,
                                     device=extractor.device)
        log_fn(
            f"{scene.name}: {scene.regions.num_regions} regions -> "
            f"{result.num_clusters} objects in {result.rounds} rounds "
            f"({timings.summary()})"
        )
    if finalize_executor is not None:
        # the other paths finalize inline: a resolved Future, so that
        # callers treat every path alike
        f: Future = Future()
        f.set_result((emb, simi, result))
        return f
    return emb, simi, result


def _remove(path: str) -> None:
    """Delete a partly written output, so that it does not look complete."""
    try:
        if os.path.exists(path):
            os.remove(path)
    except OSError:
        pass


def process_folder(
    cfg: Config,
    image_folder: str,
    shp_folder: str,
    checkpoint_path: Optional[str] = None,
    log_fn=print,
    deep_pixels: str = "error",
    mesh=None,
    write_labelmaps: bool = False,
    stream_tiles: Optional[int] = None,
    watch_seconds: Optional[float] = None,
    watch_iterations: Optional[int] = None,
    extractor: Optional[FeatureExtractor] = None,
    stats: Optional[dict] = None,
    device: torch.device | str = "cuda",
) -> list[str]:
    """Walk the per-scene folders of the reference's layout: each subfolder
    of ``shp_folder`` holds PointsGCS.shp (and lines.shp), the polygons are
    ``<folder>.shp`` beside it and the raster is ``image_folder/<folder>.tif``.
    Writes ``<model>_features.h5`` and the ``simi`` field per scene, and
    with ``write_labelmaps`` the merged map as ``<model>_merged.tif`` (for
    scenes with a ``<folder>_labels.npy`` superpixel sidecar; the others
    are skipped with a log line). Returns the names of the scenes done.

    One scene ahead is loaded and staged on a prefetch thread, and each
    scene's host tail runs on a finalize thread while the next one is
    dispatched. A scene that fails is logged and skipped. ``watch_seconds``
    rescans the folder every N seconds for new scenes (failed ones retry),
    ``watch_iterations`` bounds the scans. ``extractor`` reuses a warm
    extractor (its model wins over ``checkpoint_path``). ``stats`` receives
    ``{"scene_done_ts": [...]}``, the ``time.perf_counter()`` of each
    scene's completion.

    With ``mesh`` every rank of the mesh walks the same folder, and each
    scene goes through ``process_scene(mesh=...)``: rank 0 alone writes
    the .h5, the ``simi`` field and the label maps; no scene is staged
    ahead.
    """
    from deepmerge_tpu_torch.geodata.ingest import load_scene
    from deepmerge_tpu_torch.train.sampler import stage_scene

    if extractor is None:
        extractor = FeatureExtractor(
            load_params(cfg, checkpoint_path),
            batch_size=cfg.data.eval_batch_size, device=device, mesh=mesh)
    tag = cfg.model.name
    writer = mesh is None or mesh.rank == 0

    def scan_jobs(skip):
        jobs = []
        for entry in sorted(os.listdir(shp_folder)):
            sub = os.path.join(shp_folder, entry)
            points = os.path.join(sub, "PointsGCS.shp")
            if entry in skip or not os.path.isdir(sub) \
                    or not os.path.exists(points):
                continue
            jobs.append((
                entry,
                os.path.join(image_folder, f"{entry}.tif"),
                os.path.join(shp_folder, f"{entry}.shp"),
                points,
                os.path.join(sub, "lines.shp"),
                os.path.join(sub, f"{tag}_features.h5"),
            ))
        return jobs

    done: list[str] = []
    failed: list[tuple[str, str]] = []
    # the streamed path stages its own strips: a whole prefetched scene
    # would defeat its memory bound; a mesh extractor stages per scene
    prestage = mesh is None and (stream_tiles is None or stream_tiles <= 1)

    def finish(entry, h5_path, scene, fut):
        try:
            _, _, result = fut.result()
            if stats is not None:
                stats.setdefault("scene_done_ts", []).append(
                    time.perf_counter())
            if write_labelmaps and writer and result is not None:
                if os.path.exists(os.path.join(shp_folder,
                                               f"{entry}_labels.npy")):
                    out_tif = os.path.join(shp_folder, entry,
                                           f"{tag}_merged.tif")
                    write_label_geotiff(out_tif, result.label_map(scene),
                                        scene.meta.get("geotransform"))
                    log_fn(f"  merged label map -> {out_tif}")
                else:
                    log_fn(f"  no {entry}_labels.npy superpixel sidecar — "
                           "skipping label-map export")
            done.append(entry)
        except Exception as e:  # a bad scene must not stop the walk
            failed.append((entry, str(e)))
            log_fn(f"FAILED {entry}: {e}")
            if writer:
                _remove(h5_path)

    def walk(jobs):
        with ThreadPoolExecutor(max_workers=1) as pool, \
                ThreadPoolExecutor(max_workers=1) as fin_pool:
            def submit(job):
                entry, image, polygons, points, lines, _ = job

                def load():
                    labels_npy = os.path.join(shp_folder,
                                              f"{entry}_labels.npy")
                    labels = (np.load(labels_npy)
                              if os.path.exists(labels_npy) else None)
                    t0 = time.perf_counter()
                    scene = load_scene(image, polygons, points, lines,
                                       name=entry, deep_pixels=deep_pixels,
                                       labels=labels)
                    t1 = time.perf_counter()
                    ds = None
                    if prestage and scene.regions.num_points:
                        ds = stage_scene(scene, cfg.data, extractor.device)
                        prestage_scene(extractor, scene, ds, cfg.data,
                                       max(cfg.merge.edge_batch, 1))
                    log_fn(f"  prefetch[{entry}]: ingest {t1 - t0:.3f}s "
                           f"stage {time.perf_counter() - t1:.3f}s")
                    return scene, ds

                return pool.submit(load)

            # one scene ahead: its ingest and staging overlap this scene
            futures = [submit(j) for j in jobs[:1]]
            pending = None  # (entry, h5_path, scene, finalize future)
            for i, (entry, _, _, _, lines, h5_path) in enumerate(jobs):
                this_future, futures[i] = futures[i], None
                if i + 1 < len(jobs):
                    futures.append(submit(jobs[i + 1]))
                store = None
                try:
                    t0 = time.perf_counter()
                    scene, ds = this_future.result()
                    t1 = time.perf_counter()
                    log_fn(f"processing {entry} "
                           f"({scene.regions.num_points} points)")
                    store = FeatureStore(h5_path) if writer else None
                    fut = process_scene(
                        cfg, scene, store=store, lines_path=lines,
                        log_fn=log_fn, extractor=extractor, mesh=mesh,
                        stream_tiles=stream_tiles, device_scene=ds,
                        finalize_executor=fin_pool,
                    )
                    t2 = time.perf_counter()
                except Exception as e:  # ingest, staging or dispatch
                    failed.append((entry, str(e)))
                    log_fn(f"FAILED {entry}: {e}")
                    if store is not None:
                        store.close()
                    if writer:
                        _remove(h5_path)
                    continue
                if pending is not None:
                    finish(*pending)
                t3 = time.perf_counter()
                log_fn(f"  walk[{entry}]: wait-prefetch {t1 - t0:.3f}s "
                       f"dispatch {t2 - t1:.3f}s "
                       f"wait-finalize(prev) {t3 - t2:.3f}s")
                pending = (entry, h5_path, scene, fut)
            if pending is not None:
                finish(*pending)

    iteration = 0
    while True:
        walk(scan_jobs(skip=set(done)))
        iteration += 1
        if watch_iterations is not None and iteration >= watch_iterations:
            break
        if watch_seconds is None:
            break  # one pass by default, like the reference's walk
        time.sleep(watch_seconds)
    if failed:
        log_fn(f"{len(failed)} scene(s) failed: "
               f"{sorted(set(f[0] for f in failed))}")
    return done
