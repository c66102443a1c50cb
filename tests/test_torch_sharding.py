"""The port's scale-out path (``deepmerge_tpu_torch.parallel``) against the
JAX package's ``parallel`` and the port's single-device paths, on the CPU.

The host staging (``pad_scene``, ``shard_scene_columns``,
``stage_scene_shards``, ``merge_sharded_approx``) runs in this process and
must be bit-identical to the JAX package's. The collective paths run in
spawned ranks over gloo (``tests/torch_dist_worker.py``; two ranks, and four
for the strips): ``distributed_merge``'s labels and rounds equal to the JAX
package's ``distributed_merge`` on two of the eight virtual CPU devices and
to the port's ``device_merge``; ``extract_and_merge_sharded`` with two and
four strips (some of them empty), float32, w8a8, w8a8-static with its
scales broadcast from rank 0, and v4 with its BatchNorm buffers, giving
the partition of the port's single-device ``merge_scene_device`` and of
the JAX package on the same imported weights, its strip embeddings within
1e-5 relative of the single-device ones; the mesh ``FeatureExtractor``,
``process_scene(mesh=...)`` and ``process_folder(mesh=...)`` (embeddings
and ``simi`` within 1e-5, the same partition, only rank 0 writing).

Thresholds lie strictly between two distinct edge distances of the
single-device embeddings, so that no decision sits on the knife edge that
the collective SUM's other summation order could flip.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer.extract import FeatureExtractor as JaxExtractor
from deepmerge_tpu.infer.merge import merge_scene_device as jmerge_device
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.ops import labelprop as jlabelprop
from deepmerge_tpu.ops import patches as jpatches
from deepmerge_tpu.parallel import distributed as jdist
from deepmerge_tpu.parallel.mesh import make_mesh as jmake_mesh
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    MergeConfig,
    ModelConfig,
)
from deepmerge_tpu_torch.geodata.synthetic import generate_scene
from deepmerge_tpu_torch.infer import driver as tdrv
from deepmerge_tpu_torch.infer.extract import FeatureExtractor
from deepmerge_tpu_torch.infer.merge import merge_scene_device
from deepmerge_tpu_torch.ops import labelprop as tlabelprop
from deepmerge_tpu_torch.ops import patches as tpatches
from deepmerge_tpu_torch.ops.segment import edge_distances, segment_mean
from deepmerge_tpu_torch.parallel import distributed as tdist
from tests.helpers import unclamped_max_window
from tests.torch_dist_worker import port_model as _port_model
from tests.torch_dist_worker import run_ranks
from tests.torch_dist_worker import wide_scene as _widened

TOL = 1e-5
TINY_V3 = ModelConfig(variant="v3", input_image_scales=(16, 32, 64), cube=8,
                      embed_dim=64, depth=(2, 1, 1), num_heads=4, out_dim=32,
                      dtype="float32")
TINY_V4 = ModelConfig(variant="v4", input_image_scales=(16, 32, 64), cube=8,
                      embed_dim=32, depth=(1, 1, 1), num_heads=4, out_dim=16,
                      dtype="float32")
# the strip scenes: one point per region across a wide mosaic, and the same
# widened by as many empty columns (its right half owns no point)
STRIPS = dict(h=128, w=768, n_regions=24, n_objects=6, points_per_region=1,
              seed=11)
STRIPS_V4 = dict(h=96, w=768, n_regions=24, n_objects=6, points_per_region=1,
                 seed=13)
EMPTY_W = 768
SERVE = dict(h=192, w=192, n_regions=40, n_objects=6, seed=7)
ROUNDS = 8


def _jax_cfg(mcfg):
    return jconfig.ModelConfig(**dataclasses.asdict(mcfg))


def _jax_dcfg(dcfg):
    return jconfig.DataConfig(**dataclasses.asdict(dcfg))


def _between(scene, emb):
    """An absolute threshold midway between the two distinct edge
    distances around the median."""
    remb = segment_mean(torch.as_tensor(emb),
                        torch.as_tensor(scene.regions.point_region),
                        scene.regions.num_regions)
    d = edge_distances(remb, torch.as_tensor(scene.rag.edges)).numpy()
    ds = np.unique(d)
    k = len(ds) // 2
    return float(0.5 * (ds[k - 1] + ds[k]))


@pytest.fixture(scope="module")
def flax_weights():
    """JAX's initial parameters of the tiny v3 and v4 (with its
    batch_stats), and the port's state dicts from them."""
    out = {}
    for name, mcfg in (("v3", TINY_V3), ("v4", TINY_V4)):
        variables = init_params(build_model(_jax_cfg(mcfg)), jax.random.key(0))
        variables = jax.tree.map(np.asarray, variables)
        out[name] = (variables, state_dict_from_flax(
            variables["params"], mcfg, variables.get("batch_stats")))
    return out


def _merge_cases():
    rng = np.random.RandomState(3)
    R, P, E = 37, 61, 53
    chain = dict(pr=np.array([0, 1, 2], np.int32), R=3, max_rounds=8,
                 edges=np.array([[0, 1], [1, 2]], np.int32))
    return {
        "random": dict(emb=rng.randn(P, 5).astype(np.float32),
                       pr=rng.randint(0, R, P).astype(np.int32), R=R,
                       edges=rng.randint(0, R, (E, 2)).astype(np.int32),
                       thr=2.0, max_rounds=12),
        # both chain edges pass at once, and the merged mean would not
        "nonmonotone": dict(chain, thr=1.0, emb=np.array(
            [[1.8, 0.0], [0.9, 0.0], [0.0, 0.0]], np.float32)),
        # the merged mean enables a second round's merge
        "two_rounds": dict(chain, thr=1.4, emb=np.array(
            [[0.0, 0.0], [0.9, 0.0], [2.2, 0.0]], np.float32)),
        # three points over two ranks: the padding point (region R) must
        # join no cluster; counted in region R - 1, its zeros would pull
        # that region's mean to within the threshold of region 1
        "padding": dict(chain, thr=1.0, emb=np.array(
            [[0.0, 5.0], [1.2, 0.0], [3.0, 0.0]], np.float32)),
    }


@pytest.fixture(scope="module")
def sharded_cases(flax_weights):
    """Each extract-and-merge case with its single-device references: the
    port's embeddings and partition, and the threshold between two edge
    distances."""
    cases = {}
    for name, mcfg, kw, pad_w, worlds in (
            ("f32", TINY_V3, STRIPS, 0, (2, 4)),
            ("f32_empty", TINY_V3, STRIPS, EMPTY_W, (2, 4)),
            ("w8a8", dataclasses.replace(TINY_V3, quantize="w8a8"), STRIPS,
             0, (2,)),
            ("w8a8_static", dataclasses.replace(
                TINY_V3, quantize="w8a8-static"), STRIPS, 0, (2,)),
            ("v4", TINY_V4, STRIPS_V4, 0, (2,))):
        sd = flax_weights[mcfg.variant][1]
        scene = _widened(kw, pad_w)
        dcfg = DataConfig(patch_sizes=(16, 32, 64),
                          max_window=unclamped_max_window(scene),
                          eval_batch_size=16)
        cases[name] = dict(mcfg=mcfg, state_dict=sd, scene=kw, pad_w=pad_w,
                           dcfg=dcfg, max_rounds=ROUNDS, worlds=worlds)
        if name != "w8a8_static":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ex = FeatureExtractor(_port_model(mcfg, sd), batch_size=16,
                                      device="cpu")
            emb = ex.extract_scene_device(scene, dcfg)
            cases[name]["thr"] = _between(scene, emb)
            cases[name]["emb"] = emb.numpy()
    # w8a8-static takes the w8a8 case's threshold; its reference waits for
    # the scales the ranks calibrate
    cases["w8a8_static"]["thr"] = cases["w8a8"]["thr"]
    return cases


@pytest.fixture(scope="module")
def serving_case(flax_weights):
    cfg = Config(model=TINY_V3,
                 data=DataConfig(patch_sizes=(16, 32, 64), max_window=128,
                                 eval_batch_size=16),
                 merge=MergeConfig(engine="device", max_rounds=ROUNDS,
                                   threshold_quantile=None))
    sd = flax_weights["v3"][1]
    scene = generate_scene(**SERVE)
    ex = FeatureExtractor(_port_model(TINY_V3, sd), batch_size=16,
                          device="cpu")
    emb = ex.extract_scene_device(scene, cfg.data).numpy()
    cfg = dataclasses.replace(cfg, merge=dataclasses.replace(
        cfg.merge, threshold=_between(scene, emb)))
    return dict(cfg=cfg, state_dict=sd, scene=SERVE, ex=ex)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, sharded_cases, serving_case):
    spec = dict(merge=_merge_cases(), sharded=sharded_cases,
                serving={k: v for k, v in serving_case.items() if k != "ex"})
    return run_ranks("merge+sharded+serving+mesh", 2, spec,
                     tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, sharded_cases):
    return run_ranks("sharded+mesh", 4, dict(sharded=sharded_cases),
                     tmp_path_factory.mktemp("ranks4"))


# ------------------------------------------------- host staging (in process)


@pytest.mark.parametrize("channels", [1, 3, 4, 5])
def test_pad_scene_bit_identical(channels):
    img = np.random.RandomState(channels).randint(
        0, 256, (37, 53, channels)).astype(np.uint8)
    for caps in ((128, 256, 128), 384):
        got = tpatches.pad_scene(img, caps)
        want = jpatches.pad_scene(img, caps)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("pad_w", [0, EMPTY_W], ids=["full", "empty"])
def test_shard_scene_columns_bit_identical(n_shards, pad_w):
    ours, theirs = _widened(STRIPS, pad_w), jsynthetic.generate_scene(
        **STRIPS)
    theirs.image = ours.image
    got, got_b = tdist.shard_scene_columns(ours, n_shards)
    want, want_b = jdist.shard_scene_columns(theirs, n_shards)
    np.testing.assert_array_equal(got_b, want_b)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        assert g.strip == w.strip
        for field in ("regions", "points", "internal_edges"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    if pad_w:
        assert any(len(g.points) == 0 for g in got)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("pad_w", [0, EMPTY_W], ids=["full", "empty"])
def test_stage_scene_shards_bit_identical(n_shards, pad_w):
    ours, theirs = _widened(STRIPS, pad_w), jsynthetic.generate_scene(
        **STRIPS)
    theirs.image, theirs.labels = ours.image, ours.labels
    dcfg = DataConfig(patch_sizes=(16, 32, 64),
                      max_window=unclamped_max_window(ours))
    got = tdist.stage_scene_shards(ours, dcfg, n_shards)
    want = jdist.stage_scene_shards(theirs, _jax_dcfg(dcfg), n_shards)
    assert got.caps == want.caps and got.num_regions == want.num_regions
    for field in ("tiles", "centers", "point_region", "features", "inner",
                  "object_", "edges", "edge_valid"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    if pad_w and n_shards > 1:
        # the strip that owns no point: one column, sentinel rows only
        assert (got.point_region[-1] == got.num_regions).all()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_merge_sharded_approx_bit_identical(n_shards):
    from deepmerge_tpu.geodata.synthetic import generate_scene as jgen

    ours, theirs = generate_scene(h=192, w=192, n_regions=40, n_objects=6,
                                  seed=7), jgen(h=192, w=192, n_regions=40,
                                                n_objects=6, seed=7)
    obj = ours.object_of_region[ours.regions.point_region]
    r = np.random.RandomState(1)
    emb = (np.eye(8, dtype=np.float32)[obj % 8] * 4
           + 0.05 * r.randn(ours.regions.num_points, 8).astype(np.float32))
    got = tdist.merge_sharded_approx(ours, emb, n_shards, threshold=1.0,
                                     max_rounds=8, device="cpu")
    want = jdist.merge_sharded_approx(theirs, emb, n_shards, threshold=1.0,
                                      max_rounds=8)
    np.testing.assert_array_equal(got.region_to_cluster,
                                  want.region_to_cluster)
    assert (got.num_clusters, got.rounds, got.edges_scored) == (
        want.num_clusters, want.rounds, want.edges_scored)


@pytest.mark.parametrize("margin,fires", [(0.0, True), (9e-6, True),
                                          (2e-5, False), (np.inf, False)])
def test_knife_edge_warning_fires_where_jax_does(margin, fires):
    for warn in (tdist._warn_knife_edge, jdist._warn_knife_edge):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            warn(margin, 1.0)
        assert any("knife edge" in str(x.message) for x in w) == fires


# -------------------------------------------------- collective merge (ranks)


@pytest.mark.parametrize("case", ["random", "nonmonotone", "two_rounds",
                                  "padding"])
def test_distributed_merge_matches_jax_and_device_merge(ranks2, case):
    c = _merge_cases()[case]
    mesh = jmake_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    want, want_rounds = jdist.distributed_merge(
        c["emb"], c["pr"], c["R"], c["edges"], mesh, threshold=c["thr"],
        max_rounds=c["max_rounds"])
    single, single_rounds = tlabelprop.device_merge(
        torch.from_numpy(c["emb"]), torch.from_numpy(c["pr"]),
        torch.from_numpy(c["edges"]), torch.ones(len(c["edges"]), dtype=bool),
        c["thr"], num_regions=c["R"], max_rounds=c["max_rounds"])
    jsingle, _ = jlabelprop.device_merge(
        jnp.asarray(c["emb"]), jnp.asarray(c["pr"]), jnp.asarray(c["edges"]),
        jnp.ones(len(c["edges"]), bool), c["thr"], num_regions=c["R"],
        max_rounds=c["max_rounds"])
    np.testing.assert_array_equal(want, np.asarray(jsingle))
    for out in ranks2:
        got, rounds = out["merge"][case]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, single.numpy())
        assert rounds == int(want_rounds) == int(single_rounds)
    if case in ("nonmonotone", "two_rounds"):
        assert int(want_rounds) >= 1 and len(np.unique(want)) < c["R"]


def test_knife_edge_warning_on_the_ranks(ranks2):
    """d² = threshold² on an edge warns on every rank; a threshold with
    margin stays silent."""
    for out in ranks2:
        assert out["knife"] == {"edge": True, "margin": False}


# --------------------------------------------- extract and merge (ranks)


def _check_sharded(out, case, ref_labels, ref_emb):
    got = out["sharded"][case]
    np.testing.assert_array_equal(got["labels"], ref_labels)
    assert got["num_clusters"] == len(np.unique(ref_labels))
    assert not got["knife"], got["knife"]
    if len(got["points"]):
        want = ref_emb[got["points"]]
        scale = np.abs(want).max()
        np.testing.assert_allclose(got["emb"], want, rtol=TOL,
                                   atol=TOL * scale)
    else:
        assert got["emb"].shape[0] == 0


@pytest.mark.parametrize("case,world", [
    ("f32", 2), ("f32", 4), ("f32_empty", 2), ("f32_empty", 4),
    ("w8a8", 2), ("v4", 2)])
def test_extract_and_merge_sharded_single_device_partition(
        ranks2, ranks4, sharded_cases, case, world):
    c = sharded_cases[case]
    scene = _widened(c["scene"], c["pad_w"])
    want = merge_scene_device(scene, c["emb"], threshold=c["thr"],
                              max_rounds=ROUNDS)
    assert 1 < want.num_clusters < scene.regions.num_regions
    outs = ranks2 if world == 2 else ranks4
    for out in outs:
        _check_sharded(out, case, want.region_to_cluster, c["emb"])
    if case == "f32_empty":
        assert any(len(o["sharded"][case]["points"]) == 0 for o in outs)
        assert outs[0]["sharded"][case]["tile_shape"][0] == world


@pytest.mark.parametrize("case", ["f32", "v4"])
def test_extract_and_merge_sharded_matches_jax(ranks2, sharded_cases,
                                               flax_weights, case):
    """The same partition as the JAX package's single-device extraction
    and device merge on the same imported weights."""
    c = sharded_cases[case]
    variables = flax_weights[c["mcfg"].variant][0]
    jscene = jsynthetic.generate_scene(**c["scene"])
    jx = JaxExtractor(build_model(_jax_cfg(c["mcfg"])), variables["params"],
                      batch_stats=variables.get("batch_stats"),
                      batch_size=16)
    emb = jx.extract_scene(jscene, _jax_dcfg(c["dcfg"]))
    np.testing.assert_allclose(emb, c["emb"], rtol=TOL,
                               atol=TOL * np.abs(emb).max())
    want = jmerge_device(jscene, emb, threshold=c["thr"], max_rounds=ROUNDS)
    for out in ranks2:
        np.testing.assert_array_equal(out["sharded"][case]["labels"],
                                      want.region_to_cluster)


def test_extract_and_merge_sharded_static_scales_broadcast(ranks2,
                                                           sharded_cases):
    """w8a8-static without scales: rank 0 calibrates, every rank gets the
    same scales, and the partition is the single-device one at them."""
    c = sharded_cases["w8a8_static"]
    amax = [out["sharded"]["w8a8_static"]["act_amax"] for out in ranks2]
    assert amax[0] and all(v.max() > 0 for v in amax[0].values())
    for other in amax[1:]:
        for k, v in amax[0].items():
            np.testing.assert_array_equal(other[k], v)
    scene = _widened(c["scene"], 0)
    ex = FeatureExtractor(_port_model(c["mcfg"], c["state_dict"], {
        k: torch.from_numpy(v) for k, v in amax[0].items()}),
        batch_size=16, device="cpu")
    emb = ex.extract_scene_device(scene, c["dcfg"]).numpy()
    want = merge_scene_device(scene, emb, threshold=c["thr"],
                              max_rounds=ROUNDS)
    for out in ranks2:
        _check_sharded(out, "w8a8_static", want.region_to_cluster, emb)


# ------------------------------------- mesh extractor and drivers (ranks)


def test_mesh_extractor_embeddings(ranks2, serving_case):
    c = serving_case
    scene = generate_scene(**c["scene"])
    want = c["ex"].extract_scene_device(scene, c["cfg"].data).numpy()
    for out in ranks2:
        for key in ("emb_device", "emb_host"):
            got = out["serving"][key]
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=TOL,
                                       atol=TOL * np.abs(want).max())


def test_process_scene_mesh_matches_single_device(ranks2, serving_case):
    c = serving_case
    scene = generate_scene(**c["scene"])
    emb, simi, want = tdrv.process_scene(c["cfg"], scene, extractor=c["ex"],
                                         fused=False, log_fn=lambda *_: None)
    assert 1 < want.num_clusters < scene.regions.num_regions
    for out in ranks2:
        got = out["serving"]
        np.testing.assert_allclose(got["scene_emb"], emb, rtol=TOL,
                                   atol=TOL * np.abs(emb).max())
        np.testing.assert_allclose(got["simi"], simi, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got["labels"], want.region_to_cluster)
        assert got["rounds"] == want.rounds


def test_only_rank_0_writes(ranks2, serving_case):
    scene = generate_scene(**serving_case["scene"])
    r0, r1 = (out["serving"] for out in ranks2)
    assert (r0["store_rows"], r1["store_rows"]) == (
        scene.regions.num_points, 0)
    assert (r0["simi_written"], r1["simi_written"]) == (True, False)
    assert r0["done"] == r1["done"] == [scene.name]
    tag = serving_case["cfg"].model.name
    for name in (f"{tag}_features.h5", f"{tag}_merged.tif"):
        assert name in r0["folder_files"] and name not in r1["folder_files"]


def test_mesh_refuses_the_single_device_paths(ranks2):
    for out in ranks2:
        for what, msg in out["serving"]["refusals"].items():
            assert msg is not None and "single-device" in msg, what


def test_mesh_helpers(ranks2, ranks4):
    for world, outs in ((2, ranks2), (4, ranks4)):
        for rank, out in enumerate(outs):
            m = out["mesh"]
            k = 8 // world
            assert m["rows"] == slice(rank * k, (rank + 1) * k)
            np.testing.assert_array_equal(m["shard_batch"]["a"].numpy(),
                                          np.arange(8)[m["rows"]])
            np.testing.assert_array_equal(
                m["shard_batch"]["b"][0],
                np.arange(16).reshape(8, 2)[m["rows"]])
            np.testing.assert_array_equal(m["replicated"], np.zeros(3))
    for rank, out in enumerate(ranks4):
        m = out["mesh"]["mesh2x2"]
        assert m["shape"] == {"data": 2, "model": 2}
        assert m["coords"] == {"data": rank // 2, "model": rank % 2}
        # the data axis of model coordinate m: ranks m and m + 2
        assert m["data_sum"] == 2 * (rank % 2) + 2


def test_workers_import_neither_jax_nor_the_jax_package(ranks2, ranks4):
    for out in ranks2 + ranks4:
        assert out["modules"] == []
