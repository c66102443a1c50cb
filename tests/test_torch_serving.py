"""The serving side of the PyTorch port against the JAX package, on the CPU:
the w8a8 slice, calibrated static scales, the packed serving tail,
streamed extraction, both merge engines, threshold calibration, the folder
walk, checkpoints, the CLI, and the vendored fixture scenes.

Every comparison runs both packages on the same scene and the same weights
(the tiny v3 of ``tests/test_torch_slice.py``, two blocks per stage).
Tolerances: unquantized float32 embeddings and ``simi`` within 1e-5 (the
same float32 operations summed in other orders); w8a8 float32 embeddings
within 2e-3 of the largest magnitude (a code that flips on an int8 rounding
boundary moves its row by one quant step, measured 1.8e-4); labels,
rounds, label maps and cluster counts equal under a threshold inside a
wide gap of the distances (or the same quantile on both sides); patches
bit-exact.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.geodata import ingest as jingest
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer import calibrate as jcal
from deepmerge_tpu.infer import driver as jdrv
from deepmerge_tpu.infer import extract as jext
from deepmerge_tpu.infer import merge as jmerge
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu_torch.compat.weights import (
    act_amax_from_flax,
    init_state_dict,
    state_dict_from_flax,
)
from deepmerge_tpu_torch.config import Config, DataConfig, MergeConfig, ModelConfig
from deepmerge_tpu_torch.geodata.geotiff import read_geotiff
from deepmerge_tpu_torch.geodata.ingest import export_scene, load_scene
from deepmerge_tpu_torch.geodata.shapefile import ShapefileTable
from deepmerge_tpu_torch.geodata.synthetic import generate_scene
from deepmerge_tpu_torch.infer import calibrate as tcal
from deepmerge_tpu_torch.infer import driver as tdrv
from deepmerge_tpu_torch.infer import extract as text
from deepmerge_tpu_torch.infer import merge as tmerge
from deepmerge_tpu_torch.models.s2former import S2Former

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "scene")
TINY_V3 = ModelConfig(
    variant="v3", input_image_scales=(16, 32, 64), cube=8, embed_dim=64,
    depth=(2, 2, 2), num_heads=4, out_dim=32, dtype="float32",
)
DCFG = DataConfig(patch_sizes=(16, 32, 64), max_window=128)
SCENE = dict(h=128, w=128, n_regions=24, n_objects=4, points_per_region=2,
             seed=3)
BATCH = 16  # 48 points → three chunks
Q_TOL = 2e-3
TOL = 1e-5


def _jax(cfg):
    """The JAX package's twin of a port config (ModelConfig, DataConfig or
    Config): each package runs on its own config classes, built from the
    same fields."""
    kind = type(cfg).__name__
    if kind == "Config":
        return jconfig.Config(**{f.name: _jax(getattr(cfg, f.name))
                                 for f in dataclasses.fields(cfg)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(jconfig, kind)(**dataclasses.asdict(cfg))


J_DCFG = _jax(DCFG)


def _quiet(**change):
    """The tiny v3 with ``change``, without the experimental-config
    warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return dataclasses.replace(TINY_V3, **change)


@pytest.fixture(scope="module")
def scene_and_edges():
    scene = generate_scene(**SCENE)
    edges, valid = tmerge.padded_edges(scene, 64)
    return scene, edges, valid


@pytest.fixture(scope="module")
def jscene():
    """The JAX package's own scene from the same numpy seed (equal arrays)."""
    return jsynthetic.generate_scene(**SCENE)


@pytest.fixture(scope="module")
def flax_params():
    variables = init_params(build_model(_jax(TINY_V3)), jax.random.key(0))
    return jax.tree.map(np.asarray, variables["params"])


def _port_model(mcfg, params):
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(params, mcfg), strict=True)
    return model


def _extractors(mcfg, params, batch=BATCH):
    jx = jext.FeatureExtractor(build_model(_jax(mcfg)), params,
                               batch_size=batch)
    tx = text.FeatureExtractor(_port_model(mcfg, params), batch_size=batch)
    return jx, tx


def _gap_threshold(simi, valid):
    """Midway across the widest gap in the middle half of the sorted valid
    distances: merges happen, no edge sits on the knife edge."""
    s = np.sort(np.asarray(simi)[valid])
    lo, hi = len(s) // 4, 3 * len(s) // 4
    i = lo + int(np.argmax(np.diff(s[lo:hi])))
    return float((s[i] + s[i + 1]) / 2)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


# ------------------------------------------------------ the w8a8 slice


@pytest.mark.parametrize("quantize", ["w8a8", "w8a8-static"])
def test_w8a8_slice_matches_jax(scene_and_edges, jscene, flax_params,
                                quantize):
    """The quantized segment-and-merge slice: embeddings within Q_TOL,
    labels, rounds, label map and cluster count equal (the static form
    calibrates on the first chunk in both packages)."""
    scene, edges, valid = scene_and_edges
    jx, tx = _extractors(_quiet(quantize=quantize), flax_params)
    r = scene.regions.num_regions
    simi0 = np.asarray(jx.segment_scene_device(
        jscene, J_DCFG, edges, valid, num_regions=r, max_rounds=8)[0])
    kw = dict(num_regions=r, max_rounds=8, region_map=scene.labels,
              threshold=_gap_threshold(simi0, valid), with_embeddings=True)
    want = [np.asarray(a) for a in
            jx.segment_scene_device(jscene, J_DCFG, edges, valid, **kw)]
    got = [a.numpy() for a in
           tx.segment_scene_device(scene, DCFG, edges, valid, **kw)]
    assert _rel(got[5], want[5]) <= Q_TOL
    assert _rel(got[0][valid], want[0][valid]) <= Q_TOL
    for name, g, w in zip(("labels", "rounds", "label map", "n_clusters"),
                          got[1:5], want[1:5]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got[2]) >= 1


def test_static_scales_match_jax_batch_stats(scene_and_edges, jscene,
                                            flax_params):
    """The port's calibrated ``act_amax`` equals JAX's ``batch_stats`` within
    1e-5 (the same float32 calibration forward), and serving with JAX's
    scales loaded through ``act_amax_from_flax`` gives the embeddings the
    port's own calibration gives."""
    scene, _, _ = scene_and_edges
    mcfg = _quiet(quantize="w8a8-static")
    jx, tx = _extractors(mcfg, flax_params)
    jx.extract_scene_device(jscene, J_DCFG)
    emb = tx.extract_scene_device(scene, DCFG).numpy()
    assert not tx.needs_calibration
    want = act_amax_from_flax(jax.tree.map(np.asarray, jx.batch_stats))
    assert len(want) == sum(TINY_V3.depth)
    for key, amax in want.items():
        got = tx.model.get_buffer(key)
        assert got.dtype == torch.float32 and (amax > 0).all()
        np.testing.assert_allclose(got.numpy(), amax.numpy(), rtol=1e-5)

    loaded = _port_model(mcfg, flax_params)
    loaded.set_act_amax(want)
    tx2 = text.FeatureExtractor(loaded, batch_size=BATCH)
    assert not tx2.needs_calibration
    assert _rel(tx2.extract_scene_device(scene, DCFG).numpy(), emb) <= Q_TOL


def test_static_model_refuses_to_serve_uncalibrated(flax_params):
    model = _port_model(_quiet(quantize="w8a8-static"), flax_params).eval()
    patches = [torch.rand((2, s, s, 3)) for s in TINY_V3.input_image_scales]
    with pytest.raises(ValueError, match="calibrat"):
        model(patches, torch.rand((2, 19)))
    model.calibrate(patches, torch.rand((2, 19)))
    assert model(patches, torch.rand((2, 19))).shape == (2, TINY_V3.out_dim)


# ------------------------------------------------ packed serving tail


def test_serve_packed_tail_decodes_like_jax(scene_and_edges, jscene,
                                           flax_params):
    """``serve_packed`` returns the padded embeddings and one f32 tail that
    decodes to the ``simi``, labels and rounds of the unpacked call, and to
    JAX's."""
    scene, edges, valid = scene_and_edges
    jx, tx = _extractors(TINY_V3, flax_params)
    r, e = scene.regions.num_regions, scene.rag.num_edges
    kw = dict(num_regions=r, max_rounds=8, threshold_quantile=0.5)
    emb, tail = tx.segment_scene_device(scene, DCFG, edges, valid,
                                        serve_packed=True, **kw)
    simi, labels, rounds = tx.segment_scene_device(scene, DCFG, edges, valid,
                                                   **kw)
    assert emb.shape == (48, TINY_V3.out_dim) and tail.dtype == torch.float32
    got = text.unpack_serve_tail(tail, len(edges), e, r)
    np.testing.assert_array_equal(got[0], simi.numpy()[:e])
    np.testing.assert_array_equal(got[1], labels.numpy()[:r])
    assert got[2] == int(rounds)
    j_emb, j_tail = jx.segment_scene_device(jscene, J_DCFG, edges, valid,
                                            serve_packed=True, **kw)
    want = jext.unpack_serve_tail(np.asarray(j_tail), len(edges), e, r)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), rtol=TOL,
                               atol=TOL)


def test_unpack_serve_tail_matches_jax():
    rs = np.random.default_rng(0)
    tail = np.concatenate([rs.random(10), rs.integers(0, 50, 7), [3.0]])
    tail = tail.astype(np.float32)
    got = text.unpack_serve_tail(torch.from_numpy(tail), 10, 8, 5)
    want = jext.unpack_serve_tail(tail, 10, 8, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -------------------------------------------------------- streaming


@pytest.mark.parametrize("n_strips", [1, 3])
def test_streamed_extraction_equals_whole_scene(scene_and_edges, flax_params,
                                                n_strips):
    """Column strips read the same bytes as whole-scene staging: equal
    embeddings, in point order, the store filled once."""
    scene, _, _ = scene_and_edges
    _, tx = _extractors(TINY_V3, flax_params)
    store = text.FeatureStore(None)
    got = tx.extract_scene_streamed(scene, DCFG, n_strips=n_strips,
                                    store=store)
    want = tx.extract_scene_device(scene, DCFG).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(store.read_all(), got)
    batches = tx.extract_scene(scene, DCFG)
    np.testing.assert_allclose(batches, want, rtol=TOL, atol=TOL)


def test_strip_plan_matches_jax(scene_and_edges, jscene):
    scene, _, _ = scene_and_edges
    from deepmerge_tpu_torch.ops.patches import staging_caps

    feats, inner, obj = scene.regions.point_meta()
    caps = staging_caps(inner, obj, DCFG.patch_sizes, DCFG.max_window)
    xs = scene.regions.points_yx[:, 1].astype(np.int64)
    order = np.argsort(xs, kind="stable")
    for ns in (1, 2, 3):
        got = text._plan_strips(scene, caps, xs, order, ns)
        want = jext._plan_strips(jscene, caps, xs, order, ns)
        assert got[1:] == want[1:]
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
    # the 96-pixel halo covers the 128-pixel scene: one strip or none
    budget = 320 * 320 * 4
    assert text._strips_for_budget(scene, caps, xs, order, budget) == \
        jext._strips_for_budget(jscene, caps, xs, order, budget) == 1
    for mod, sc in ((text, scene), (jext, jscene)):
        with pytest.raises(ValueError, match="no column-strip split"):
            mod._strips_for_budget(sc, caps, xs, order, budget - 1, 4)


def test_feature_store_roundtrip(tmp_path):
    """The h5 layout of the JAX package (one growable ``dataset``) and the
    in-memory mode, with random access by point id."""
    rs = np.random.default_rng(1)
    a, b = rs.random((5, 4), np.float32), rs.random((3, 4), np.float32)
    for path in (None, str(tmp_path / "f.h5")):
        if path is not None and not text.HAS_H5PY:
            continue
        store = text.FeatureStore(path)
        store.append(a)
        store.append(b)
        np.testing.assert_array_equal(store.get_by_id(6), b[1])
        np.testing.assert_array_equal(store.get_by_id(-1), b[2])
        np.testing.assert_array_equal(store.read_all(), np.concatenate([a, b]))
        store.close()
        if path is not None:
            np.testing.assert_array_equal(jext.FeatureStore.open(path),
                                          np.concatenate([a, b]))


# ------------------------------------------------- merge and calibration


def _scene_embeddings(scene, flax_params):
    _, tx = _extractors(TINY_V3, flax_params)
    return tx.extract_scene_device(scene, DCFG).numpy()


def test_host_engine_equals_device_engine(scene_and_edges, jscene,
                                          flax_params):
    """The host ``MergeEngine`` (union-find) and ``merge_scene_device``
    (label propagation) give one partition, and the host engine gives the
    JAX host engine's result."""
    scene, edges, valid = scene_and_edges
    emb = _scene_embeddings(scene, flax_params)
    simi = tmerge.edge_distances(
        tmerge.segment_mean(torch.from_numpy(emb),
                            torch.from_numpy(scene.regions.point_region),
                            scene.regions.num_regions),
        torch.from_numpy(scene.rag.edges)).numpy()
    thr = _gap_threshold(simi, np.ones(len(simi), bool))
    host = tmerge.merge_scene(scene, emb, threshold=thr, max_rounds=8,
                              edge_batch=64)
    dev = tmerge.merge_scene_device(scene, torch.from_numpy(emb),
                                    threshold=thr, max_rounds=8)
    np.testing.assert_array_equal(host.region_to_cluster,
                                  dev.region_to_cluster)
    assert host.num_clusters == dev.num_clusters < scene.regions.num_regions
    want = jmerge.merge_scene(jscene, emb, threshold=thr, max_rounds=8,
                              edge_batch=64)
    np.testing.assert_array_equal(host.region_to_cluster,
                                  want.region_to_cluster)
    assert (host.rounds, host.edges_scored, host.merges_per_round) == \
        (want.rounds, want.edges_scored, want.merges_per_round)
    want_dev = jmerge.merge_scene_device(jscene, emb, threshold=thr,
                                         max_rounds=8)
    assert (dev.rounds, dev.edges_scored) == (want_dev.rounds,
                                              want_dev.edges_scored)


def test_union_find_matches_native():
    rs = np.random.default_rng(2)
    edges = rs.integers(0, 40, (30, 2))
    uf = tmerge.UnionFind(40)
    uf.union_edges(edges)
    got = uf.labels()
    want = tmerge.connected_labels(40, edges)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_calibrate_threshold_matches_jax(scene_and_edges, jscene,
                                        flax_params):
    scene, _, _ = scene_and_edges
    emb = _scene_embeddings(scene, flax_params)
    got = tcal.calibrate_threshold(scene, emb, max_rounds=8)
    want = jcal.calibrate_threshold(jscene, emb, max_rounds=8)
    assert len(got.table) == len(want.table) > 1
    for g, w in zip(got.table, want.table):
        assert g[1:] == w[1:]
        assert g[0] == pytest.approx(w[0], rel=1e-6)
    assert (got.clusters, got.disagreement) == (want.clusters,
                                                want.disagreement)
    assert got.threshold == pytest.approx(want.threshold, rel=1e-6)


# ----------------------------------------------------- the folder walk


def _export_folder(root, seeds=(1, 2)):
    """Scenes in the reference folder layout: ``images/<name>.tif``,
    ``shps/<name>.shp`` with ``shps/<name>/{PointsGCS,lines}.shp`` and the
    ``shps/<name>_labels.npy`` superpixel sidecar."""
    images, shps = root / "images", root / "shps"
    for seed in seeds:
        scene = generate_scene(h=96, w=96, n_regions=12, n_objects=3,
                               points_per_region=2, seed=seed,
                               name=f"tile{seed}")
        stage = root / "stage"
        paths = export_scene(scene, str(stage))
        os.makedirs(images, exist_ok=True)
        os.makedirs(shps / scene.name, exist_ok=True)
        os.rename(paths["image"], images / f"{scene.name}.tif")
        for ext in (".shp", ".shx", ".dbf"):
            os.rename(str(stage / f"{scene.name}{ext}"),
                      shps / f"{scene.name}{ext}")
            for base in ("PointsGCS", "lines"):
                src = stage / scene.name / f"{base}{ext}"
                if src.exists():
                    os.rename(str(src), shps / scene.name / f"{base}{ext}")
        np.save(shps / f"{scene.name}_labels.npy", scene.labels)
    return images, shps


def _walk_outputs(shps, cfg, names):
    out = {}
    for name in names:
        table = ShapefileTable.read(str(shps / name / "lines.shp"))
        h5 = shps / name / f"{cfg.model.name}_features.h5"
        tif = read_geotiff(str(shps / name / f"{cfg.model.name}_merged.tif"))
        a = tif.array.astype(np.int64)
        labels = a[..., 0] | a[..., 1] << 8 | a[..., 2] << 16
        rows = text.FeatureStore.open(str(h5)).shape[0] \
            if text.HAS_H5PY else None
        out[name] = (np.asarray(table.get_field("simi"), np.float64), labels,
                     rows)
    return out


@pytest.fixture(scope="module")
def pth_checkpoint(tmp_path_factory, flax_params):
    from deepmerge_tpu.compat.torch_export import save_torch_checkpoint

    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    save_torch_checkpoint({"params": flax_params}, _jax(TINY_V3), path)
    return path


def test_process_folder_matches_jax(tmp_path, pth_checkpoint):
    """Two scenes through ``process_folder`` with the prefetch and finalize
    threads and ``write_labelmaps``, in both packages from the same .pth:
    the same scenes done, h5 rows = points, ``simi`` re-read from each
    lines.shp within 1e-5, and equal merged label maps (threshold at the
    median edge distance on both sides)."""
    cfg = Config(model=TINY_V3,
                 data=dataclasses.replace(DCFG, eval_batch_size=16),
                 merge=MergeConfig(threshold_quantile=0.5, max_rounds=8))
    outs = {}
    for tag, walk, c in (("jax", jdrv.process_folder, _jax(cfg)),
                         ("torch", tdrv.process_folder, cfg)):
        images, shps = _export_folder(tmp_path / tag)
        kw = dict(device="cpu") if tag == "torch" else {}
        done = walk(c, str(images), str(shps), pth_checkpoint,
                    log_fn=lambda *_: None, write_labelmaps=True, **kw)
        assert done == ["tile1", "tile2"]
        outs[tag] = _walk_outputs(shps, cfg, done)
    for name in ("tile1", "tile2"):
        (s_t, map_t, rows_t), (s_j, map_j, rows_j) = (
            outs["torch"][name], outs["jax"][name])
        np.testing.assert_allclose(s_t, s_j, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(map_t, map_j)
        assert rows_t == rows_j
        if rows_t is not None:
            assert rows_t == 24  # 12 regions x 2 points


def test_process_folder_skips_done_and_failed_scenes(tmp_path, flax_params):
    """A scene whose raster is missing fails alone (logged, no h5 left);
    a second scan skips the scenes already done."""
    images, shps = _export_folder(tmp_path, seeds=(1, 2, 3))
    os.remove(images / "tile2.tif")
    cfg = Config(model=_quiet(quantize="w8a8"),
                 data=dataclasses.replace(DCFG, eval_batch_size=16))
    logs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fresh-weights warning
        done = tdrv.process_folder(cfg, str(images), str(shps),
                                   log_fn=logs.append, watch_seconds=0.0,
                                   watch_iterations=2, device="cpu")
    assert done == ["tile1", "tile3"]
    assert sum(line.startswith("FAILED tile2") for line in logs) == 2
    assert sum(line.startswith("processing tile1") for line in logs) == 1
    assert not (shps / "tile2" / f"{cfg.model.name}_features.h5").exists()


def test_process_scene_paths_agree(scene_and_edges, flax_params):
    """The fused serving path, the split device path, the host engine and
    the streamed path of ``process_scene`` give the same ``simi`` and
    partition."""
    scene, _, _ = scene_and_edges
    model = _port_model(TINY_V3, flax_params)
    tx = text.FeatureExtractor(model, batch_size=BATCH)
    results = []
    for fused, engine, tiles in ((True, "device", None),
                                 (False, "device", None),
                                 (False, "host", None),
                                 (None, "device", 3)):
        cfg = Config(model=TINY_V3, data=DCFG,
                     merge=MergeConfig(threshold=1.0, engine=engine,
                                       max_rounds=8))
        emb, simi, res = tdrv.process_scene(
            cfg, scene, extractor=tx, fused=fused, stream_tiles=tiles,
            log_fn=lambda *_: None)
        results.append((emb, simi, res))
    emb0, simi0, res0 = results[0]
    for emb, simi, res in results[1:]:
        np.testing.assert_allclose(emb, emb0, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(simi, simi0, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(res.region_to_cluster,
                                      res0.region_to_cluster)


# --------------------------------------------------------- checkpoints


def test_load_params_reads_reference_pth(pth_checkpoint, flax_params):
    """A .pth written by the JAX package loads strictly and equals
    ``state_dict_from_flax`` of the same parameters."""
    cfg = Config(model=TINY_V3)
    model = tdrv.load_params(cfg, pth_checkpoint)
    want = state_dict_from_flax(flax_params, TINY_V3)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_load_params_fresh_and_refused():
    cfg = Config(model=TINY_V3)
    with pytest.warns(UserWarning, match="FRESH"):
        model = tdrv.load_params(cfg)
    for k, v in init_state_dict(TINY_V3, seed=0).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="export-ckpt"):
        tdrv.load_params(cfg, "weights.msgpack")


def test_mesh_is_not_ported(scene_and_edges):
    scene, _, _ = scene_and_edges
    with pytest.raises(NotImplementedError, match="scale-out"):
        tdrv.process_scene(Config(model=TINY_V3), scene, mesh=object())


# ----------------------------------------------------------------- CLI


def _cli(*args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "deepmerge_tpu_torch",
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


def test_cli_config_matches_jax_config():
    out = _cli("config", "model.quantize=w8a8", "merge.max_rounds=4")
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert got["model"]["quantize"] == "w8a8"
    assert got["merge"]["max_rounds"] == 4
    assert got["data"] == json.loads(jconfig.Config().to_json())["data"]


def test_cli_extract_on_cpu(tmp_path):
    """``export-synthetic`` then ``extract --device cpu`` on the tiny v3:
    the h5 holds a row per point, lines.shp gains ``simi``, the merged map
    is written."""
    out = _cli("export-synthetic", "--out", str(tmp_path), "--size", "96",
               "--regions", "10", "--objects", "3")
    assert out.returncode == 0, out.stderr
    small = ["model.embed_dim=64", "model.depth=1,1,1", "model.num_heads=4",
             "model.out_dim=16", "model.dtype=float32",
             "model.input_image_scales=16,32,64", "data.patch_sizes=16,32,64",
             "data.eval_batch_size=16", "data.max_window=128",
             "model.quantize=w8a8"]
    d = tmp_path / "synthetic"
    out = _cli("--device", "cpu", "extract",
               "--image", str(tmp_path / "synthetic.tif"),
               "--polygons", str(tmp_path / "synthetic.shp"),
               "--points", str(d / "PointsGCS.shp"),
               "--lines", str(d / "lines.shp"),
               "--h5", str(tmp_path / "f.h5"),
               "--labels", str(tmp_path / "synthetic_labels.npy"),
               "--out-labels", str(tmp_path / "merged.tif"), *small)
    assert out.returncode == 0, out.stderr
    assert "embedded" in out.stdout and "merged label map" in out.stdout
    lines = ShapefileTable.read(str(d / "lines.shp"))
    assert "simi" in lines.field_names()
    assert os.path.exists(tmp_path / "merged.tif")
    n_points = int(out.stdout.split("embedded ")[1].split()[0])
    if text.HAS_H5PY:
        assert text.FeatureStore.open(str(tmp_path / "f.h5")).shape[0] == \
            n_points


def test_cli_process_folder_on_cpu(tmp_path, pth_checkpoint):
    """``process-folder --device cpu --write-labelmaps`` over a two-scene
    reference-layout folder from a .pth: per scene the .h5 (a row per
    point), ``simi`` in lines.shp and the merged GeoTIFF."""
    images, shps = _export_folder(tmp_path)
    small = ["model.embed_dim=64", "model.depth=2,2,2", "model.num_heads=4",
             "model.out_dim=32", "model.dtype=float32",
             "model.input_image_scales=16,32,64", "data.patch_sizes=16,32,64",
             "data.eval_batch_size=16", "data.max_window=128",
             "model.quantize=w8a8"]
    out = _cli("--device", "cpu", "process-folder", "--images", str(images),
               "--shapefiles", str(shps), "--checkpoint-dir", pth_checkpoint,
               "--write-labelmaps", *small)
    assert out.returncode == 0, out.stderr
    assert "processed 2 scenes" in out.stdout
    name = Config(model=TINY_V3).model.name
    for scene in ("tile1", "tile2"):
        table = ShapefileTable.read(str(shps / scene / "lines.shp"))
        simi = np.asarray(table.get_field("simi"), np.float64)
        assert simi.size and np.isfinite(simi).all()
        assert os.path.exists(shps / scene / f"{name}_merged.tif")
        if text.HAS_H5PY:
            assert text.FeatureStore.open(
                str(shps / scene / f"{name}_features.h5")).shape == (24, 32)


def test_cli_needs_a_card_unless_cpu(monkeypatch, capsys):
    from deepmerge_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["process-folder", "--images", "x", "--shapefiles", "y"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["train", "--mesh"],
                                  ["import-ckpt", "anything"],
                                  ["export-ckpt", "anything"]],
                         ids=["train", "import-ckpt", "export-ckpt"])
def test_cli_unported_commands_say_where_they_live(argv, capsys):
    """What the CLI does not carry yet (training is ported, its sharded
    ``--mesh`` form is not) exits 2 and names where it lives."""
    from deepmerge_tpu_torch.__main__ import main

    assert main(argv) == 2
    assert "deepmerge_tpu" in capsys.readouterr().err


# ------------------------------------------- fixture scenes (bit-exact)


@pytest.mark.parametrize("name", ["synthetic", "deep16"])
def test_fixture_scene_patches_and_process_scene(name):
    """The vendored scenes: ``synthetic`` (3 bands) and the uint16
    ``deep16`` (one band, ``deep_pixels="shift"``). Patches of every point
    bit-exact against the JAX package; ``process_scene``'s embeddings and
    ``simi`` within 1e-5 and the same partition."""
    from deepmerge_tpu.ops import patches as jpatches
    from deepmerge_tpu.train.sampler import stage_scene as jstage
    from deepmerge_tpu_torch.ops import patches as tpatches
    from deepmerge_tpu_torch.train.sampler import stage_scene as tstage

    prefix = os.path.join(FIX, name)
    args = (prefix + ".tif", prefix + ".shp",
            os.path.join(prefix, "PointsGCS.shp"),
            os.path.join(prefix, "lines.shp"))
    kw = dict(labels=np.load(os.path.join(
        FIX, "labels.npy" if name == "synthetic" else "deep16_labels.npy")),
        deep_pixels="shift" if name == "deep16" else "error")
    scene = load_scene(*args, **kw)
    jscene = jingest.load_scene(*args, **kw)
    c = scene.image.shape[-1]
    mcfg = dataclasses.replace(TINY_V3, depth=(1, 1, 1), in_channels=c)
    dcfg = dataclasses.replace(DCFG, eval_batch_size=8)

    jds, tds = jstage(jscene, _jax(dcfg)), tstage(scene, dcfg)
    targets = tuple(dcfg.patch_sizes) + (1,)
    scales, _ = tpatches.adaptive_scales(tds.point_inner, tds.point_object,
                                         targets)
    kw = dict(patch_sizes=tuple(mcfg.input_image_scales), caps=tds.caps,
              out_channels=c)
    got = tpatches.extract_multiscale_patches(
        tds.padded, torch.as_tensor(tds.points_yx, dtype=torch.int32),
        scales, **kw)
    want = jpatches.extract_multiscale_patches(
        jds.padded, jax.numpy.asarray(jds.points_yx),
        jax.numpy.asarray(scales.numpy()), quantize_uint8=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    params = jax.tree.map(np.asarray, init_params(
        build_model(_jax(mcfg)), jax.random.key(0))["params"])
    cfg = Config(model=mcfg, data=dcfg,
                 merge=MergeConfig(threshold_quantile=0.5, max_rounds=4))
    quiet = dict(log_fn=lambda *_: None)
    j_emb, j_simi, j_res = jdrv.process_scene(
        _jax(cfg), jscene, build_model(_jax(mcfg)), params, None, **quiet)
    t_emb, t_simi, t_res = tdrv.process_scene(
        cfg, scene, _port_model(mcfg, params), device="cpu", **quiet)
    np.testing.assert_allclose(t_emb, j_emb, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_simi, j_simi, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_res.region_to_cluster,
                                  j_res.region_to_cluster)
    assert t_res.rounds == j_res.rounds
