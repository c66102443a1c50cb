"""One rank of the PyTorch port's multi-process CPU checks (gloo).

Launched once per rank by ``tests/test_torch_sharding.py``,
``tests/test_torch_dp_train.py`` and ``tests/test_torch_tp.py``::

    python tests/torch_dist_worker.py <job> <rank> <world> <port> <dir>

It joins a gloo process group on ``tcp://127.0.0.1:<port>``, reads the job's
inputs from ``<dir>/spec.pkl`` (weights, configs, thresholds, written by the
test), runs the job's cases through the port's ``parallel`` paths and writes
what it saw to ``<dir>/out-<rank>.pkl``. It imports the port only: the
test holds the results against the JAX package and the port's single-device
paths. ``run_ranks`` starts the ranks from a test.
"""

import dataclasses
import datetime
import hashlib
import itertools
import os
import pickle
import socket
import subprocess
import sys
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deepmerge_tpu_torch.geodata.synthetic import (  # noqa: E402
    generate_scene,
    make_training_pairs,
)
from deepmerge_tpu_torch.models.s2former import S2Former  # noqa: E402
from deepmerge_tpu_torch.parallel import distributed  # noqa: E402
from deepmerge_tpu_torch.parallel.mesh import (  # noqa: E402
    all_reduce_,
    make_mesh,
    replicate,
    shard_batch,
    shard_rows,
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(job: str, world: int, spec: dict, root) -> list[dict]:
    """``job`` of ``tests/torch_dist_worker.py`` on ``world`` gloo ranks,
    each a fresh interpreter without JAX; returns each rank's results."""
    root = str(root)
    worker = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(worker))
    with open(os.path.join(root, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, worker, job, str(r), str(world), port, root],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError(f"rank timed out: {job}")
    outs = []
    for r in range(world):
        with open(os.path.join(root, f"out-{r}.pkl"), "rb") as f:
            out = pickle.load(f)
        assert "error" not in out, f"rank {r}:\n{out['error']}\n{logs[r]}"
        outs.append(out)
    return outs


def wide_scene(kw, pad_w=0):
    """A synthetic scene, its image (and label map) widened by ``pad_w``
    columns on the right that hold no sample point: the strips there own
    no point."""
    scene = generate_scene(**kw)
    if pad_w:
        scene.image = np.pad(scene.image, ((0, 0), (0, pad_w), (0, 0)))
        scene.labels = np.pad(scene.labels, ((0, 0), (0, pad_w)),
                              mode="edge")
    return scene


def port_model(mcfg, state_dict, act_amax=None):
    model = S2Former(mcfg)
    model.load_state_dict(state_dict, strict=True)
    if act_amax is not None:
        model.set_act_amax(act_amax)
    return model


def job_merge(spec, mesh, out):
    """``distributed_merge`` on the random and non-monotone cases, and the
    knife-edge warning."""
    got = {}
    for name, c in spec["merge"].items():
        got[name] = distributed.distributed_merge(
            c["emb"], c["pr"], c["R"], c["edges"], mesh,
            threshold=c["thr"], max_rounds=c["max_rounds"])
    out["merge"] = got
    fired = {}
    for name, thr in (("edge", 1.0), ("margin", 2.0)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            distributed.distributed_merge(
                np.array([[0.0, 0.0], [1.0, 0.0]], np.float32),
                np.array([0, 1], np.int32), 2,
                np.array([[0, 1]], np.int32), mesh, threshold=thr,
                max_rounds=4)
        fired[name] = any("knife edge" in str(x.message) for x in w)
    out["knife"] = fired


def job_sharded(spec, mesh, out):
    """``extract_and_merge_sharded`` on each case, the strip embeddings
    captured where they are made."""
    captured = []
    embed = distributed._embed_strip

    def capture(ex, staged, s, cfg, channels):
        emb = embed(ex, staged, s, cfg, channels)
        captured.append((staged, emb))
        return emb

    distributed._embed_strip = capture
    res = {}
    try:
        for name, c in spec["sharded"].items():
            if mesh.shape["data"] not in c["worlds"]:
                continue
            scene = wide_scene(c["scene"], c.get("pad_w", 0))
            model = port_model(c["mcfg"], c["state_dict"])
            captured.clear()
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                r = distributed.extract_and_merge_sharded(
                    model, scene, c["dcfg"], mesh, threshold=c["thr"],
                    max_rounds=c["max_rounds"])
            staged, emb = captured[0]
            s = mesh.coords["data"]
            strip_of = distributed._strip_of_regions(scene,
                                                     mesh.shape["data"])
            pts = np.where(strip_of[scene.regions.point_region] == s)[0]
            amax = {n: b.detach().cpu().numpy().copy()
                    for n, b in model.named_buffers()
                    if n.endswith("act_amax")}
            res[name] = dict(
                labels=r.region_to_cluster, rounds=r.rounds,
                num_clusters=r.num_clusters, edges_scored=r.edges_scored,
                emb=emb.cpu().numpy(), points=pts, act_amax=amax,
                tile_shape=staged.tiles.shape, knife=[str(x.message)
                                                     for x in w])
    finally:
        distributed._embed_strip = embed
    out["sharded"] = res


def export_folder(root, scene):
    """``scene`` in the reference folder layout under ``root``."""
    from deepmerge_tpu_torch.geodata.ingest import export_scene

    images, shps, stage = (os.path.join(root, d)
                           for d in ("images", "shps", "stage"))
    paths = export_scene(scene, stage)
    os.makedirs(images, exist_ok=True)
    os.makedirs(os.path.join(shps, scene.name), exist_ok=True)
    os.rename(paths["image"], os.path.join(images, f"{scene.name}.tif"))
    for ext in (".shp", ".shx", ".dbf"):
        os.rename(os.path.join(stage, f"{scene.name}{ext}"),
                  os.path.join(shps, f"{scene.name}{ext}"))
        for base in ("PointsGCS", "lines"):
            src = os.path.join(stage, scene.name, f"{base}{ext}")
            if os.path.exists(src):
                os.rename(src, os.path.join(shps, scene.name,
                                            f"{base}{ext}"))
    np.save(os.path.join(shps, f"{scene.name}_labels.npy"), scene.labels)
    return images, shps


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def job_serving(spec, mesh, out, root):
    """The mesh ``FeatureExtractor``, ``process_scene(mesh=...)`` and
    ``process_folder(mesh=...)``, each rank writing into its own copy of
    the scene's folder; and the single-device paths that refuse a mesh."""
    from deepmerge_tpu_torch.infer import driver
    from deepmerge_tpu_torch.infer.extract import (
        FeatureExtractor,
        FeatureStore,
    )

    c = spec["serving"]
    cfg = c["cfg"]
    scene = generate_scene(**c["scene"])
    ex = FeatureExtractor(port_model(cfg.model, c["state_dict"]),
                          batch_size=cfg.data.eval_batch_size, mesh=mesh)
    got = dict(emb_device=ex.extract_scene_device(scene, cfg.data).numpy(),
               emb_host=ex.extract_scene(scene, cfg.data))

    mine = os.path.join(root, f"rank{mesh.rank}")
    images, shps = export_folder(mine, scene)
    lines = os.path.join(shps, scene.name, "lines.shp")
    dbf = lines[:-4] + ".dbf"
    before = _digest(dbf)
    store = FeatureStore(None)
    emb, simi, result = driver.process_scene(
        cfg, scene, store=store, lines_path=lines, extractor=ex, mesh=mesh,
        log_fn=lambda *_: None)
    got.update(scene_emb=emb, simi=simi, labels=result.region_to_cluster,
               rounds=result.rounds, store_rows=sum(
                   len(x) for x in store._chunks),
               simi_written=_digest(dbf) != before)
    done = driver.process_folder(cfg, images, shps, log_fn=lambda *_: None,
                                 write_labelmaps=True, extractor=ex,
                                 mesh=mesh)
    tag = cfg.model.name
    got.update(done=done, folder_files=sorted(
        os.listdir(os.path.join(shps, scene.name))))
    refusals = {}
    for what, call in (
            ("segment_scene_device", lambda: ex.segment_scene_device(
                scene, cfg.data, scene.rag.edges, np.ones(
                    scene.rag.num_edges, bool),
                num_regions=scene.regions.num_regions)),
            ("extract_scene_streamed", lambda: ex.extract_scene_streamed(
                scene, cfg.data, n_strips=2)),
            ("process_scene stream_tiles", lambda: driver.process_scene(
                cfg, scene, extractor=ex, mesh=mesh, stream_tiles=2,
                log_fn=lambda *_: None))):
        try:
            call()
            refusals[what] = None
        except ValueError as e:
            refusals[what] = str(e)
    got["refusals"] = refusals
    got["h5"] = f"{tag}_features.h5"
    out["serving"] = got


def job_mesh(spec, mesh, out):
    """``shard_batch``, ``replicate`` and, on four ranks, a 2x2 mesh whose
    data-axis sums cover two ranks."""
    batch = {"a": torch.arange(8), "b": (np.arange(16).reshape(8, 2),)}
    got = {"shard_batch": shard_batch(batch, mesh),
           "rows": shard_rows(8, mesh)}
    t = torch.full((3,), float(mesh.rank))
    got["replicated"] = replicate({"t": t}, mesh)["t"].numpy()
    if dist.get_world_size() == 4:
        m2 = make_mesh(n_data=2, n_model=2, devices="cpu")
        x = torch.tensor([float(m2.rank)])
        got["mesh2x2"] = dict(shape=m2.shape, coords=m2.coords,
                              data_sum=float(all_reduce_(x, m2)[0]))
    out["mesh"] = got


def job_dp(spec, mesh, out, root):
    """The data-parallel trainer: two steps of ``make_train_step(cfg,
    mesh)`` on this rank's rows of each batch, the dropout masks of a
    ``BatchShard``, and ``train(use_mesh=True)`` end to end."""
    from deepmerge_tpu_torch.ops.dropout import dropout
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.driver import train
    from deepmerge_tpu_torch.train.sampler import PairSampler

    res = {}
    scene = generate_scene(**spec["scene"])
    pos, neg = make_training_pairs(scene)
    for name, c in spec["dp"].items():
        cfg = c["cfg"]
        b = cfg.data.batch_size
        state = loop.create_train_state(cfg, c["steps_per_epoch"],
                                        device="cpu")
        replicate(state.model, mesh)
        step = loop.make_train_step(cfg, mesh)
        sampler = PairSampler(scene, pos, neg, cfg.data, "cpu")
        losses, grads = [], None
        for batch in itertools.islice(sampler.epoch_batches(
                c["epoch_seed"], b, rows=shard_rows(b, mesh)), c["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if grads is None:  # step 0's gradient, summed over the ranks
                grads = {k: p.grad.clone() for k, p in
                         state.model.named_parameters()
                         if p.grad is not None}
        res[name] = dict(losses=losses, grads=grads, state={
            k: v.detach().clone() for k, v in
            state.model.state_dict().items()})
    out["dp"] = res

    state = loop.create_train_state(spec["dp"]["v3"]["cfg"], device="cpu")
    draws, scale = loop._step_draws(state, mesh, spec["mask_pairs"])
    out["mask"] = dict(mask=dropout(torch.ones(
        2 * spec["mask_pairs"], 3, 5), 0.5, draws).numpy(), scale=scale,
        rows=draws.rows.numpy())

    cfg = spec["e2e"]["cfg"]
    mine = os.path.join(root, f"rank{mesh.rank}")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=os.path.join(mine, "ck"),
        log_dir=os.path.join(mine, "logs")))
    state, history = train(cfg, scene=scene, use_mesh=True,
                           max_steps_per_epoch=spec["e2e"]["steps"],
                           log_fn=lambda *_: None, device="cpu")
    out["e2e"] = dict(
        losses=history.train_losses, step=state.step,
        state={k: v.detach().clone()
               for k, v in state.model.state_dict().items()},
        written=sorted(os.listdir(mine)) if os.path.exists(mine) else [])


def _torch_batch(batch):
    return {k: (tuple(torch.from_numpy(x) for x in v) if isinstance(v, tuple)
                else torch.from_numpy(v)) for k, v in batch.items()}


def job_tp(spec, out):
    """Tensor parallelism on a 1x4 and a 2x2 (data x model) mesh: the
    forward of ``S2Former(cfg, mesh)`` on ``shard_params``' slices, each
    rank's slices, one training step of ``make_train_step(cfg, mesh)`` per
    case (this rank's data rows) with ``gather_params`` of the updated
    weights, and a quantized model refused."""
    from deepmerge_tpu_torch.parallel.mesh import (
        gather_params,
        shard_params,
    )
    from deepmerge_tpu_torch.train import loop

    c = spec["tp"]
    res = {}
    for name, (n_data, n_model) in c["meshes"].items():
        mesh = make_mesh(n_data=n_data, n_model=n_model, devices="cpu")
        got = dict(coords=mesh.coords)
        model = S2Former(c["mcfg"], mesh)
        mine = shard_params(c["state_dict"], mesh)
        model.load_state_dict(mine, strict=True)
        with torch.inference_mode():
            got["forward"] = model(tuple(torch.from_numpy(p)
                                         for p in c["patches"]),
                                   torch.from_numpy(c["designed"])).numpy()
        got["slices"] = {k: v for k, v in mine.items()
                         if k.startswith("blocks0.0.")}
        got["gathered"] = gather_params(mine, mesh)
        steps = {}
        for run, cfg in c["train"].items():
            state = loop.create_train_state(cfg, 2, c["state_dict"],
                                            device="cpu", mesh=mesh)
            step = loop.make_train_step(cfg, mesh)
            batch = shard_batch(_torch_batch(c["batch"]), mesh)
            state, m = step(state, batch)
            sd = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
            steps[run] = dict(loss=float(m["loss"]), state=sd,
                              gathered=gather_params(sd, mesh))
        got["train"] = steps
        try:
            S2Former(dataclasses.replace(c["mcfg"], quantize="w8a8"), mesh)
            got["quantized"] = None
        except ValueError as e:
            got["quantized"] = str(e)
        res[name] = got
    out["tp"] = res


def main():
    job, rank, world, port, root = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    # a rank that fails makes the others' next collective time out
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        with open(os.path.join(root, "spec.pkl"), "rb") as f:
            spec = pickle.load(f)
        mesh = make_mesh(devices="cpu")
        for part in job.split("+"):
            if part == "merge":
                job_merge(spec, mesh, out)
            elif part == "sharded":
                job_sharded(spec, mesh, out)
            elif part == "serving":
                job_serving(spec, mesh, out, root)
            elif part == "mesh":
                job_mesh(spec, mesh, out)
            elif part == "dp":
                job_dp(spec, mesh, out, root)
            elif part == "tp":
                job_tp(spec, out)
            else:
                raise ValueError(f"unknown job {part}")
        out["modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "deepmerge_tpu"))
    except Exception:
        out["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(root, f"out-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    return 1 if "error" in out else 0


if __name__ == "__main__":
    sys.exit(main())
