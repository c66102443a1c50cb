"""The PyTorch port's benchmark (``deepmerge_tpu_torch/bench.py``) against the
repository's root ``bench.py`` and the JAX package, on the CPU.

- The knobs: for each value of ``BENCH_QUANT``, ``BENCH_CHAIN``,
  ``BENCH_MODEL`` (v5, vit) and ``BENCH_BT`` the port's ``ModelConfig``
  equals, field by field, the one the root ``main()`` passes to the JAX
  ``build_model`` (captured with ``build_model`` patched to raise); so do
  the serving, training and mesh modes' configs. vit is the one
  difference: the port sets its fixed patch sizes, without which the root
  script stops in ``build_model``.
- The workload: ``make_scene`` + ``prep_scene`` give the padded edges, the
  validity mask, the point regions and the region map of the JAX
  package's ``generate_scene`` padded as ``bench.py:431-452`` pads them.
- The routes: the fused map, ``BENCH_FUSED_MAP=0`` and ``BENCH_STREAM=2``
  against the JAX package's same calls (``bench.py:458-497``), on the same
  scene and weights (the JAX tiny-v3 init through ``state_dict_from_flax``,
  float32): ``simi`` within 1e-5 (the same float32 operations, summed in
  another order), labels, rounds, the merged map and the cluster count
  equal at a threshold midway across a wide gap of the distances. The
  three routes give one map in the port.
- The JSON lines of the headline, the serving walk (the store in memory)
  and training have the root script's keys, without ``vs_baseline`` and
  the TPU targets, with ``device`` (and ``store``).
- Without a card the entry point raises (in process and as
  ``python -m``), the mesh mode too unless ``BENCH_MESH_PLATFORM=cpu``.

The mesh mode runs in ``tests/test_torch_sharding.py``, on the ranks that
file's other cases spawn.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer.extract import FeatureExtractor as JaxExtractor
from deepmerge_tpu.models import s2former as js2former
from deepmerge_tpu.models.s2former import init_params
from deepmerge_tpu.ops.labelprop import (
    device_score_and_merge,
    merged_label_map,
)
from deepmerge_tpu.train.sampler import stage_scene
from deepmerge_tpu_torch import bench
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.infer import extract
from deepmerge_tpu_torch.models.s2former import build_model
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_image_scales=(16, 32, 64), cube=8, embed_dim=64,
            depth=(1, 1, 1), num_heads=4, out_dim=16, dtype="float32")
SMALL_DATA = dict(patch_sizes=(16, 32, 64), max_window=128)
SIDE = 256        # the routes' scene, 128 regions at the default density
BATCH = "32"      # four chunks of its points
# the root bench.py's JSON keys by mode (:151-161, :251-257, :343-359,
# :578-627), what the port removes (TPU figures) and what it adds
JAX_KEYS = {
    "main": {"metric", "value", "unit", "vs_baseline", "density_curve",
             "density_curve_unit", "target_mpix_per_s_per_chip",
             "max_density_meeting_target"},
    "serve": {"metric", "value", "unit", "vs_baseline", "link_h2d_mbps",
              "steady_scene_seconds", "steady_mpix_per_s"},
    "train": {"metric", "value", "unit", "vs_baseline"},
}
REMOVED = {"vs_baseline", "target_mpix_per_s_per_chip",
           "max_density_meeting_target"}
ADDED = {"main": {"device"}, "serve": {"device", "store"},
         "train": {"device"}}


def _root_bench():
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Captured(Exception):
    pass


def _capture():
    def raise_(*args, **kwargs):
        raise _Captured(args, kwargs)
    return raise_


@pytest.fixture
def bench_env(monkeypatch):
    """A clean ``BENCH_*`` environment; returns a setter."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return dict(env)
    return set_env


def _small(cfg, **data):
    """``cfg`` with the tiny model and small patches."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **TINY),
        data=dataclasses.replace(cfg.data, **SMALL_DATA, **data))


# ------------------------------------------------------------------ knobs


@pytest.mark.parametrize("value", [None, "1", "0", "w8a8-static",
                                   "w8a8+attn"])
def test_bench_quantize_matches_root(bench_env, value):
    env = bench_env({} if value is None else {"BENCH_QUANT": value})
    assert bench._bench_quantize(env) == _root_bench()._bench_quantize()


@pytest.mark.parametrize("env", [
    {}, {"BENCH_QUANT": "0"}, {"BENCH_QUANT": "1"},
    {"BENCH_QUANT": "w8a8-static"}, {"BENCH_QUANT": "w8a8+attn"},
    {"BENCH_CHAIN": "0"}, {"BENCH_CHAIN": "2"}, {"BENCH_CHAIN": "2",
                                                 "BENCH_QUANT": "0"},
    {"BENCH_MODEL": "v5"}, {"BENCH_MODEL": "vit"}, {"BENCH_BT": "4"},
], ids=lambda e: "-".join(f"{k[6:]}={v}" for k, v in e.items()) or "default")
def test_main_model_config_matches_root(bench_env, monkeypatch, env):
    env = bench_env(env)
    monkeypatch.setattr(js2former, "build_model", _capture())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the experimental knobs' notes
        with pytest.raises(_Captured) as got:
            _root_bench().main()
        ours = bench.config_for("main", env).model
    (want,), _ = got.value.args
    if env.get("BENCH_MODEL") == "vit":
        want = dataclasses.replace(want, input_image_scales=bench.VIT_SCALES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)


def test_serve_config_matches_root(bench_env, monkeypatch, tmp_path):
    """The whole ``Config`` the root ``serve_bench`` hands ``load_params``
    (after exporting one 64² scene)."""
    from deepmerge_tpu.infer import driver as jdriver

    env = bench_env({"BENCH_SERVE": "1", "BENCH_SCENE": "64",
                     "BENCH_QUANT": "0", "BENCH_BATCH": "512"})
    monkeypatch.setattr(jdriver, "load_params", _capture())
    with pytest.raises(_Captured) as got:
        _root_bench().serve_bench()
    (want,), _ = got.value.args
    ours = bench.config_for("serve", env)
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)


def test_train_config_and_scene_match_root(bench_env, monkeypatch):
    """The root ``train_bench``'s scene arguments, sampler data config,
    model config and ``Config`` (handed to ``create_train_state``), at
    ``BENCH_TRAIN_FUSED=1``; its scene is replaced by a small one."""
    from deepmerge_tpu.geodata import synthetic as jsyn
    from deepmerge_tpu.train import loop as jloop
    from deepmerge_tpu.train import sampler as jsampler

    env = bench_env({"BENCH_TRAIN": "1", "BENCH_TRAIN_FUSED": "1",
                     "BENCH_MODEL": "v5"})
    seen = {}
    generate = jsyn.generate_scene

    def small_scene(**kw):
        seen["scene"] = kw
        return generate(h=64, w=64, n_regions=16, n_objects=4,
                        points_per_region=3, seed=0)

    class Sampler:
        def __init__(self, scene, pos, neg, data):
            seen["data"] = data

        def __len__(self):
            return 1

    monkeypatch.setattr(jsyn, "generate_scene", small_scene)
    monkeypatch.setattr(jsampler, "FusedPairSampler", Sampler)
    monkeypatch.setattr(js2former, "build_model",
                        lambda mcfg: seen.setdefault("model", mcfg))
    monkeypatch.setattr(jloop, "create_train_state", _capture())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(_Captured) as got:
            _root_bench().train_bench()
        ours = bench.config_for("train", env)
    (_, want, _, _), _ = got.value.args
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
    assert dataclasses.asdict(ours.data) == dataclasses.asdict(seen["data"])
    assert dataclasses.asdict(ours.model) == dataclasses.asdict(seen["model"])
    scene_kw = {}
    monkeypatch.setattr(
        "deepmerge_tpu_torch.geodata.synthetic.generate_scene",
        lambda **kw: scene_kw.update(kw))
    bench.train_scene()
    assert scene_kw == seen["scene"]


def test_mesh_config_matches_root(bench_env, monkeypatch):
    env = bench_env({"BENCH_MESH": "1", "BENCH_QUANT": "w8a8-static"})
    monkeypatch.setattr(js2former, "build_model", _capture())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(_Captured) as got:
            _root_bench().mesh_bench()
        ours = bench.config_for("mesh", env).model
    (want,), _ = got.value.args
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)


# --------------------------------------------------------------- workload


def test_prep_scene_matches_root_padding():
    """``bench.py:431-452`` on the JAX package's scene against the port's
    ``make_scene`` + ``prep_scene``, at 256² and the default density."""
    n = bench.n_regions_for(SIDE, SIDE, bench.DEFAULT_DENSITY)
    assert n == max(int(8192 / 4.194304 * SIDE * SIDE / 1e6), 16)
    js = jsynthetic.generate_scene(h=SIDE, w=SIDE, n_regions=n,
                                   n_objects=256, points_per_region=1,
                                   seed=0)
    edges = js.rag.edges.astype(np.int32)
    pad = (-len(edges)) % 2048
    edge_valid = np.ones(len(edges), bool)
    if pad:
        edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
        edge_valid = np.concatenate([edge_valid, np.zeros(pad, bool)])

    scene = bench.make_scene(SIDE, SIDE, n)
    st = bench.prep_scene(scene, bench.config_for("main", {}).data, "cpu",
                          stage=False)
    assert st.device_scene is None
    for name, got, want in (
            ("edges", st.edges, edges), ("edge_valid", st.edge_valid,
                                         edge_valid),
            ("point_region", st.point_region, js.regions.point_region),
            ("region_map", st.region_map, js.labels)):
        assert got.dtype in (torch.int32, torch.bool), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert len(edges) % 2048 == 0 and pad > 0


# ----------------------------------------------------------------- routes


ROUTES = {"fused": dict(), "unfused": dict(fused_map=False),
          "stream": dict(stream=2)}


@pytest.fixture(scope="module")
def routes_setup():
    """The route's workload in both packages, the weights of the JAX init,
    and a threshold midway across the widest gap in the middle half of
    the sorted edge distances."""
    env = {"BENCH_QUANT": "0", "BENCH_BATCH": BATCH}
    cfg = _small(bench.config_for("main", env))
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg.model))
    jdcfg = jconfig.DataConfig(**dataclasses.asdict(cfg.data))
    jm = js2former.build_model(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_params(jm, key))(jax.random.key(0))["params"])
    n = bench.n_regions_for(SIDE, SIDE, bench.DEFAULT_DENSITY)
    scene = bench.make_scene(SIDE, SIDE, n)
    model = build_model(cfg.model)
    model.load_state_dict(state_dict_from_flax(params, cfg.model),
                          strict=True)
    st = bench.prep_scene(scene, cfg.data, "cpu")
    ex = extract.FeatureExtractor(model, batch_size=int(BATCH),
                                  device="cpu")
    simi = bench.run_scene(ex, cfg.data, st)["simi"].numpy()
    s = np.sort(simi[st.edge_valid.numpy()])
    lo, hi = len(s) // 4, 3 * len(s) // 4
    i = lo + int(np.argmax(np.diff(s[lo:hi])))
    assert s[i + 1] - s[i] > 1e-3 * s[i + 1]
    thr = float((s[i] + s[i + 1]) / 2)
    jscene = jsynthetic.generate_scene(h=SIDE, w=SIDE, n_regions=n,
                                       n_objects=256, points_per_region=1,
                                       seed=0)
    jx = JaxExtractor(jm, params, batch_size=int(BATCH))
    return dict(cfg=cfg, model=model, scene=scene, thr=thr, jx=jx,
                jscene=jscene, jdcfg=jdcfg, edges=st.edges.numpy(),
                valid=st.edge_valid.numpy(), ports={})


def _port_route(setup, route):
    if route not in setup["ports"]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # clamped windows
            out, res = bench.segment_and_merge_bench(
                setup["cfg"], setup["scene"], device="cpu",
                model=setup["model"], runs=1, threshold=setup["thr"],
                **ROUTES[route])
        setup["ports"][route] = (out, res)
    return setup["ports"][route]


def _jax_route(setup, route):
    """``bench.py:458-497``'s route on the JAX package."""
    jx, jscene, jdcfg = setup["jx"], setup["jscene"], setup["jdcfg"]
    edges, valid, thr = setup["edges"], setup["valid"], setup["thr"]
    r = jscene.regions.num_regions
    region_map = jnp.asarray(jscene.labels, jnp.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if route == "stream":
            emb = jx.extract_scene_streamed(jscene, jdcfg, n_strips=2)
            simi, labels, rounds = device_score_and_merge(
                jnp.asarray(emb),
                jnp.asarray(jscene.regions.point_region, jnp.int32),
                jnp.asarray(edges), jnp.asarray(valid), num_regions=r,
                max_rounds=8, threshold=thr)
            label_map, n = merged_label_map(labels, region_map)
        else:
            ds = stage_scene(jscene, jdcfg)
            kw = dict(num_regions=r, max_rounds=8, device_scene=ds,
                      threshold=thr)
            if route == "fused":
                simi, labels, rounds, label_map, n = jx.segment_scene_device(
                    jscene, jdcfg, edges, valid, region_map=region_map, **kw)
            else:
                simi, labels, rounds = jx.segment_scene_device(
                    jscene, jdcfg, edges, valid, **kw)
                label_map, n = merged_label_map(labels, region_map,
                                                jnp.int32(r))
    return dict(simi=np.asarray(simi), labels=np.asarray(labels),
                rounds=int(rounds), label_map=np.asarray(label_map),
                n_clusters=int(n))


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_jax(routes_setup, route):
    out, got = _port_route(routes_setup, route)
    want = _jax_route(routes_setup, route)
    np.testing.assert_allclose(got["simi"].numpy(), want["simi"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["label_map"].numpy(),
                                  want["label_map"])
    assert (got["rounds"], got["n_clusters"]) == (want["rounds"],
                                                  want["n_clusters"])
    r = routes_setup["scene"].regions.num_regions
    assert got["rounds"] >= 1 and 1 <= got["n_clusters"] < r
    assert out["metric"] == "end_to_end_segment_and_merge_throughput"


def test_routes_give_one_map(routes_setup):
    """The fused, unfused and streamed routes merge to one map, and it is
    the host expansion of the unfused route's labels."""
    maps = {k: _port_route(routes_setup, k)[1]["label_map"].numpy()
            for k in ROUTES}
    np.testing.assert_array_equal(maps["unfused"], maps["fused"])
    np.testing.assert_array_equal(maps["stream"], maps["fused"])
    scene = routes_setup["scene"]
    labels = _port_route(routes_setup, "unfused")[1]["labels"].numpy()
    _, dense = np.unique(labels[:scene.regions.num_regions],
                         return_inverse=True)
    np.testing.assert_array_equal(dense[scene.labels], maps["fused"])


# ------------------------------------------------------------ JSON lines


def _check_line(out, mode, metric, unit):
    assert set(out) == (JAX_KEYS[mode] - REMOVED) | ADDED[mode], set(out)
    assert out["metric"] == metric and out["unit"] == unit
    assert math.isfinite(out["value"]) and out["value"] > 0
    assert out["device"] == "cpu"
    assert "\n" not in json.dumps(out)


def test_headline_line(routes_setup):
    """The headline with its density curve (one point)."""
    setup = routes_setup
    curve = {500: bench.make_scene(SIDE, SIDE, bench.n_regions_for(
        SIDE, SIDE, 500))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out, _ = bench.segment_and_merge_bench(
            setup["cfg"], setup["scene"], device="cpu", model=setup["model"],
            runs=1, curve=curve)
    _check_line(out, "main", "end_to_end_segment_and_merge_throughput",
                "megapixels/sec/gpu")
    assert set(out["density_curve"]) == {"500"}
    assert out["density_curve_unit"] == "megapixels/sec/gpu at N regions/MPix"


def test_serving_line(tmp_path, monkeypatch):
    """Two 96² scenes through the walk, the store in memory (as where h5py
    is missing): every scene done, its ``simi`` written back."""
    from deepmerge_tpu_torch.geodata.shapefile import ShapefileTable

    monkeypatch.setattr(extract, "HAS_H5PY", False)
    n = bench.n_regions_for(96, 96, bench.DEFAULT_DENSITY)
    for seed in (1, 2):
        images, shps = bench.export_scene_folder(
            bench.make_scene(96, 96, n, seed=seed, name=f"scene{seed}"),
            str(tmp_path))
    cfg = _small(bench.config_for("serve", {"BENCH_BATCH": "16"}))
    out, done = bench.serve_bench(cfg, images, shps, 2, (96, 96),
                                  device="cpu")
    _check_line(out, "serve", "folder_serving_throughput",
                "megapixels/sec/gpu")
    assert out["store"] == "memory" and done == ["scene1", "scene2"]
    assert out["link_h2d_mbps"] > 0 and out["steady_scene_seconds"] >= 0
    for name in done:
        simi = ShapefileTable.read(os.path.join(
            shps, name, "lines.shp")).get_field("simi")
        assert np.isfinite(np.asarray(simi, np.float64)).all()
        assert not os.path.exists(os.path.join(
            shps, name, f"{cfg.model.name}_features.h5"))


def test_training_line():
    """One timed epoch (after the warm-up epoch) on a 96² scene."""
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene

    cfg = _small(bench.config_for("train", {"BENCH_BATCH": "8"}))
    scene = generate_scene(h=96, w=96, n_regions=16, n_objects=4,
                           points_per_region=2, seed=0)
    out, losses = bench.train_bench(cfg, scene, 1, device="cpu")
    _check_line(out, "train", "training_throughput", "pairs/sec/gpu")
    assert losses.ndim == 1 and len(losses) >= 1
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------- no card


def test_needs_the_card(bench_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for env in ({}, {"BENCH_SERVE": "1"}, {"BENCH_TRAIN": "1"},
                {"BENCH_MESH": "1", "BENCH_MESH_PLATFORM": "device"}):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            bench.main(bench_env(env))


def test_mesh_needs_the_card_by_default(bench_env, monkeypatch):
    """``BENCH_MESH`` without ``BENCH_MESH_PLATFORM`` runs on the card:
    gloo on the CPU only when the caller sets ``BENCH_MESH_PLATFORM=cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main(bench_env({"BENCH_MESH": "1"}))


def test_module_exits_nonzero_without_a_card(bench_env):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "deepmerge_tpu_torch.bench"],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA card" in p.stderr
