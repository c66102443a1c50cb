"""The PyTorch port's eval harness (``deepmerge_tpu_torch/eval.py``) against
the JAX package's root ``eval.py``, on the CPU.

The serving half runs on both packages with the same weights (the JAX
package's tiny-v3 init through ``state_dict_from_flax``, float32): the JAX
side composed in the test from the functions the root ``eval.py`` calls
(``FeatureExtractor.extract_scene``, ``calibrate_threshold``,
``merge_scene_device``, ``pair_disagreement``). Calibrated threshold within
1e-5, clusters and pair disagreements equal. Then the port's ``main`` on
the CPU: its JSON tail has the root script's keys, ``--serve-only``
restores the port's checkpoint and serves the same, the quantize choice
the config refuses is refused before training, and without a card it
stops unless asked for the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer.calibrate import calibrate_threshold
from deepmerge_tpu.infer.extract import FeatureExtractor
from deepmerge_tpu.infer.merge import merge_scene_device
from deepmerge_tpu.models.s2former import build_model as jbuild
from deepmerge_tpu.models.s2former import init_params
from deepmerge_tpu.utils.parity import pair_disagreement
from deepmerge_tpu_torch import eval as teval
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import Config, DataConfig, ModelConfig
from deepmerge_tpu_torch.models.s2former import build_model
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(variant="v3", input_image_scales=(16, 32, 64), cube=8,
            embed_dim=64, depth=(1, 1, 1), num_heads=4, out_dim=16,
            dtype="float32")
DATA = dict(patch_sizes=(16, 32, 64), max_window=128)
SCENE_KW = dict(h=96, w=96, n_regions=16, n_objects=4, points_per_region=2,
                noise=10.0)
TEST_SEEDS = (7, 8)
# the root eval.py's JSON tail (eval.py:183-191)
JAX_KEYS = {"config", "epochs", "train_seconds", "final_loss", "threshold",
            "calibration", "held_out"}


def _jax_serving(model, params, cfg):
    """The root ``eval.py``'s serving half (``:136-181``), composed from the
    JAX package's functions."""
    points = SCENE_KW["n_regions"] * SCENE_KW["points_per_region"]
    extractor = FeatureExtractor(model, params, batch_size=min(2000, points))
    val_scene = jsynthetic.generate_scene(seed=500, **SCENE_KW)
    cal = calibrate_threshold(val_scene,
                              extractor.extract_scene(val_scene, cfg.data),
                              max_rounds=cfg.merge.max_rounds)
    results = []
    for seed in TEST_SEEDS:
        scene = jsynthetic.generate_scene(seed=seed, **SCENE_KW)
        merged = merge_scene_device(
            scene, extractor.extract_scene(scene, cfg.data),
            threshold=cal.threshold, max_rounds=cfg.merge.max_rounds)
        dis = pair_disagreement(merged.region_to_cluster[scene.labels],
                                scene.object_of_region[scene.labels])
        results.append((merged.num_clusters, round(dis, 6)))
    return cal.threshold, results


def test_serving_half_equals_jax():
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**TINY),
                          data=jconfig.DataConfig(**DATA))
    jm = jbuild(jcfg.model)
    # init_params, jitted (its eager flax init takes seconds)
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_params(jm, key))(jax.random.key(0))["params"])
    want_thr, want = _jax_serving(jm, params, jcfg)

    cfg = Config(model=ModelConfig(**TINY), data=DataConfig(**DATA))
    model = build_model(cfg.model)
    model.load_state_dict(state_dict_from_flax(params, cfg.model),
                          strict=True)
    thr, calibration, results = teval.serve_held_out(
        cfg, model, SCENE_KW, TEST_SEEDS, calibrate=True, val_seed=500,
        device="cpu", log_fn=lambda *_: None)
    assert abs(thr - want_thr) <= 1e-5
    assert calibration["val_seed"] == 500
    assert [(r["clusters"], r["pair_disagreement"]) for r in results] == want
    assert [r["gt_objects"] for r in results] == [4, 4]


def _tail(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu`` at a tiny scene, calibrated; five epochs, so that
    the reference cadence writes a checkpoint (epoch 5) for
    ``--serve-only`` to restore."""
    monkeypatch.chdir(tmp_path)  # the loss logs land in ./logs
    args = ["--device", "cpu", "--size", "64", "--regions", "12",
            "--objects", "3", "--test-seeds", "7", "--calibrate",
            "--checkpoint-dir", str(tmp_path / "ck")]
    teval.main(args + ["--epochs", "5"])
    tail = _tail(capsys)
    assert JAX_KEYS <= set(tail) and tail["device"] == "cpu"
    assert tail["epochs"] == 5 and tail["config"]["num_heads"] == 4
    assert tail["config"] == dataclasses.asdict(
        ModelConfig(embed_dim=128, num_heads=4, depth=(2, 1, 1))) | {
            "input_image_scales": [32, 64, 128], "depth": [2, 1, 1]}
    (held,) = tail["held_out"]
    assert held["seed"] == 7 and held["gt_objects"] == 3
    assert 0.0 <= held["pair_disagreement"] <= 1.0

    teval.main(args + ["--epochs", "5", "--serve-only"])
    again = _tail(capsys)
    assert again["train_seconds"] == 0.0
    assert (again["threshold"], again["held_out"]) == (tail["threshold"],
                                                       tail["held_out"])


def test_refused_quantize_before_training(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="w8a8-static\\+attn"):
        teval.main(["--device", "cpu", "--quantize", "w8a8-static+attn",
                    "--checkpoint-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_main_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        teval.main(["--checkpoint-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
