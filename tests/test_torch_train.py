"""The training slice of the PyTorch port against the JAX package, on the
CPU: the tiny-v3 trainer (scanned epoch, every block through the
saved-probs attention), its per-step and host-batch forms, a checkpoint
read back by the JAX package, the driver and the CLI. The pieces (losses,
schedule, Adam, samplers, checkpoint round trip, training rules) are in
``tests/test_torch_train_pieces.py``, which shares this file's fixtures.

Every comparison gives each package its own config and scene, built from
the same arguments (the synthetic scene is numpy-seeded: equal arrays), and
the same weights (JAX's initial parameters through
``state_dict_from_flax``). Tolerances (measured in brackets):
* the float32 trainer, ``STEPS`` scanned steps at lr 1e-3 across both
  schedule boundaries: every loss within 1e-5 relative of JAX's [2.3e-6],
  and each parameter's change from its start within 5e-2 of its largest
  entry, with an RMS error within 5e-3 of its RMS [at most 1.6e-2 and
  1.8e-3, in the qkv weights and a LayerNorm scale; most tensors below
  1e-3 and 1e-4]. The attention backward rounds its operands to bf16 on
  both sides (the JAX package's ``_fused_qkv_train_bwd``), so a sum taken
  in another order can flip one bf16 rounding, and Adam's update divides
  each gradient entry by its own RMS, so an entry whose gradient is mostly
  that noise moves by a visible share of the learning rate. The key third
  of each qkv bias is such an entry everywhere: softmax does not change
  when a constant is added to every key, so its true gradient is 0 and
  both packages move it by rounding noise alone (at most a few times the
  learning rate a step; compared by that bound only), and so is the bias of
  the output projection, which the loss's difference of embeddings
  cancels.
* the host-batch steps: losses within 1e-5 relative; the eval step's and
  a checkpoint's embeddings through the JAX package within 1e-5 (the
  serving tests' bound for the float32 slice).
"""

import json
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
from deepmerge_tpu.compat.torch_import import load_torch_checkpoint
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer.extract import FeatureExtractor as JaxExtractor
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.train import loop as jloop
from deepmerge_tpu.train import sampler as jsampler
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from deepmerge_tpu_torch.geodata.synthetic import (
    generate_scene,
    make_training_pairs,
)
from deepmerge_tpu_torch.infer.extract import FeatureExtractor
from deepmerge_tpu_torch.models.s2former import S2Former
from deepmerge_tpu_torch.train import checkpoint as tckpt
from deepmerge_tpu_torch.train import loop as tloop
from deepmerge_tpu_torch.train import sampler as tsampler
from deepmerge_tpu_torch.train.driver import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(variant="v3", input_image_scales=(16, 32, 64), cube=8,
            embed_dim=64, depth=(1, 1, 1), num_heads=4, out_dim=16,
            dtype="float32")
DATA = dict(patch_sizes=(16, 32, 64), max_window=128, batch_size=8)
# two epochs of two steps each: the schedule boundaries fall at steps 2
# and 4 of the scanned run
TRAIN = dict(lr=1e-3, lr_milestones=(1, 2))
SCENE = dict(h=128, w=128, n_regions=24, n_objects=4, points_per_region=2,
             seed=3)
STEPS = 6
LOSS_TOL = 1e-5
DELTA_TOL, DELTA_RMS_TOL = 5e-2, 5e-3


def _cfgs(**train_kw):
    """(port Config, JAX Config) of the tiny v3, from the same fields."""
    kw = dict(TRAIN, **train_kw)
    port = Config(model=ModelConfig(**TINY), data=DataConfig(**DATA),
                  train=TrainConfig(**kw))
    jax_cfg = jconfig.Config(model=jconfig.ModelConfig(**TINY),
                             data=jconfig.DataConfig(**DATA),
                             train=jconfig.TrainConfig(**kw))
    return port, jax_cfg


@pytest.fixture(scope="module")
def scenes():
    return generate_scene(**SCENE), jsynthetic.generate_scene(**SCENE)


@pytest.fixture(scope="module")
def flax_params():
    _, jcfg = _cfgs()
    variables = init_params(build_model(jcfg.model), jax.random.key(0))
    return jax.tree.map(np.asarray, variables["params"])


def _samplers(scenes, cls_name="FusedPairSampler"):
    cfg, jcfg = _cfgs()
    scene, jscene = scenes
    pos, neg = make_training_pairs(scene)
    jpos, jneg = jsynthetic.make_training_pairs(jscene)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # window-cap clamping note
        ours = getattr(tsampler, cls_name)(scene, pos, neg, cfg.data)
        theirs = getattr(jsampler, cls_name)(jscene, jpos, jneg, jcfg.data)
    return ours, theirs


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


# -------------------------------------------------------------- trainer


def _jax_scanned(scenes, flax_params, steps):
    cfg, jcfg = _cfgs()
    _, sampler = _samplers(scenes)
    spe = len(sampler) // DATA["batch_size"]
    model = build_model(jcfg.model)
    state = jloop.create_train_state(model, jcfg, jax.random.key(0), spe)
    state = state.replace(params=jax.tree.map(jnp.asarray, flax_params),
                          opt_state=state.tx.init(
                              jax.tree.map(jnp.asarray, flax_params)))
    epoch_fn = jloop.make_scanned_epoch(model, jcfg, sampler.device_scene)
    arrays = sampler.epoch_arrays(11, DATA["batch_size"])
    arrays = tuple(jnp.concatenate([a, a])[:steps] for a in arrays)
    state, losses = epoch_fn(state, *arrays, jax.random.key(1))
    return spe, np.asarray(losses), jax.tree.map(np.asarray, state.params)


def test_scanned_trainer_matches_jax(scenes, flax_params):
    """``STEPS`` scanned float32 steps from JAX's initial weights on the
    same epoch arrays (one epoch's batches twice), crossing both schedule
    boundaries: JAX's loss trajectory and final parameters."""
    cfg, _ = _cfgs()
    ours, _ = _samplers(scenes)
    spe, want_losses, want_params = _jax_scanned(scenes, flax_params, STEPS)
    assert spe == len(ours) // DATA["batch_size"]
    start = state_dict_from_flax(flax_params, cfg.model)
    state = tloop.create_train_state(cfg, 2, state_dict=start,
                                    device="cpu")
    # JAX's schedule ran over its own steps-per-epoch; use the same
    state.lr = tloop.lr_schedule(cfg, spe)
    epoch_fn = tloop.make_scanned_epoch(cfg, ours.device_scene)
    arrays = ours.epoch_arrays(11, DATA["batch_size"])
    arrays = tuple(torch.cat([a, a])[:STEPS] for a in arrays)
    state, losses = epoch_fn(state, *arrays)
    assert state.step == STEPS and losses.shape == (STEPS,)
    np.testing.assert_allclose(_np(losses), want_losses, rtol=LOSS_TOL)
    want = state_dict_from_flax(want_params, cfg.model)
    got = state.model.state_dict()
    params = dict(state.model.named_parameters())
    assert params
    lr, c = TRAIN["lr"], TINY["embed_dim"]
    for k in params:
        d_got = _np(got[k]) - _np(start[k])
        d_want = _np(want[k]) - _np(start[k])
        noise = None
        if k.endswith("attn.qkv.bias"):
            noise = slice(c, 2 * c)
        elif k == "final_features_with_design.bias":
            noise = slice(None)
        if noise is not None:
            # a true gradient of 0, moved by rounding noise alone
            for d in (d_got[noise], d_want[noise]):
                assert np.abs(d).max() <= 3 * lr * STEPS, k
            keep = np.ones(d_got.shape, bool)
            keep[noise] = False
            d_got, d_want = d_got[keep], d_want[keep]
            if not keep.any():
                continue
        scale = np.abs(d_want).max()
        if scale == 0:   # never used by the forward (the unused head)
            assert np.abs(d_got).max() == 0, k
            continue
        rms = np.sqrt(((d_got - d_want) ** 2).mean() / (d_want ** 2).mean())
        assert np.abs(d_got - d_want).max() <= DELTA_TOL * scale, k
        assert rms <= DELTA_RMS_TOL, (k, rms)


def test_fused_steps_equal_the_scanned_epoch(scenes, flax_params):
    """``make_fused_train_step`` over ``epoch_batches`` runs the scanned
    epoch's operations on the same values: losses within 1e-6 relative
    (torch's CPU products may block differently for slices of the epoch's
    arrays than for a batch's own tensors; measured 1.8e-7)."""
    cfg, _ = _cfgs()
    ours, _ = _samplers(scenes)
    start = state_dict_from_flax(flax_params, cfg.model)
    a = tloop.create_train_state(cfg, 2, state_dict=start,
                                    device="cpu")
    b = tloop.create_train_state(cfg, 2, state_dict=start,
                                    device="cpu")
    arrays = ours.epoch_arrays(5, DATA["batch_size"])
    a, want = tloop.make_scanned_epoch(cfg, ours.device_scene)(
        a, *(x[:3] for x in arrays))
    step = tloop.make_fused_train_step(cfg, ours.device_scene)
    got = []
    for _, batch in zip(range(3), ours.epoch_batches(5, DATA["batch_size"])):
        b, metrics = step(b, batch)
        got.append(metrics["loss"])
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-6, atol=0)
    assert a.step == b.step == 3


def test_host_batch_steps_and_eval_match_jax(scenes, flax_params):
    """The host-batch path (``PairSampler`` batches through
    ``make_train_step``, as multi-scene training runs) gives JAX's losses
    over three steps, and ``make_eval_step`` JAX's embeddings."""
    cfg, jcfg = _cfgs()
    ours, theirs = _samplers(scenes, "PairSampler")
    model = build_model(jcfg.model)
    jstate = jloop.create_train_state(model, jcfg, jax.random.key(0), 2)
    params = jax.tree.map(jnp.asarray, flax_params)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    jstep = jloop.make_train_step(model, jcfg)
    state = tloop.create_train_state(
        cfg, 2, state_dict=state_dict_from_flax(flax_params, cfg.model),
        device="cpu")
    step = tloop.make_train_step(cfg)
    got, want = [], []
    for _, tb, jb in zip(range(3), ours.epoch_batches(9, 8),
                         theirs.epoch_batches(9, 8)):
        jstate, jm = jstep(jstate, jb, jax.random.key(1))
        state, m = step(state, tb)
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    patches, designed = tb["left_patches"], tb["left_designed"]
    eval_model = S2Former(cfg.model)
    eval_model.load_state_dict(state_dict_from_flax(flax_params, cfg.model))
    emb = tloop.make_eval_step(eval_model.eval())(patches, designed)
    j_emb = jloop.make_eval_step(model)(
        params, None, jb["left_patches"], jb["left_designed"])
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------- checkpoints


def test_checkpoint_loads_into_jax_with_equal_embeddings(tmp_path, scenes,
                                                         flax_params):
    """A port checkpoint's ``net``, loaded by the JAX package's
    ``load_torch_checkpoint``, embeds the scene as the port does."""
    cfg, jcfg = _cfgs()
    ours, _ = _samplers(scenes)
    state = tloop.create_train_state(
        cfg, 2, state_dict=state_dict_from_flax(flax_params, cfg.model),
        device="cpu")
    epoch_fn = tloop.make_scanned_epoch(cfg, ours.device_scene)
    arrays = ours.epoch_arrays(0, DATA["batch_size"])
    state, _ = epoch_fn(state, *(a[:2] for a in arrays))
    path = tckpt.CheckpointManager(str(tmp_path), cfg).save(state, 0)
    variables = load_torch_checkpoint(os.path.join(path, tckpt.PAYLOAD), jcfg)
    scene, jscene = scenes
    want = np.asarray(JaxExtractor(build_model(jcfg.model),
                                   variables["params"], batch_size=16)
                      .extract_scene_device(jscene, jcfg.data))
    model = S2Former(cfg.model)
    model.load_state_dict(state.model.state_dict(), strict=True)
    got = FeatureExtractor(model, batch_size=16, device="cpu") \
        .extract_scene_device(scene, cfg.data).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ driver and CLI


def test_driver_trains_checkpoints_and_refuses_mesh(tmp_path, scenes):
    cfg, _ = _cfgs(num_epochs=2, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path / "ck"),
                   log_dir=str(tmp_path / "logs"))
    scene, _ = scenes
    logs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, history = train(cfg, scene=scene, max_steps_per_epoch=2,
                               log_fn=logs.append, device="cpu")
        # the data-parallel trainer needs a process group (none here)
        with pytest.raises(RuntimeError, match="process group"):
            train(cfg, scene=scene, use_mesh=True, device="cpu")
    assert state.step == 4 and len(history.train_losses) == 2
    assert all(np.isfinite(history.train_losses))
    assert sum("checkpoint ->" in line for line in logs) == 2
    assert sorted(os.listdir(tmp_path / "ck")) == [
        f"{cfg.model.name}_epoch0001", f"{cfg.model.name}_epoch0002"]


def test_cli_train_on_cpu(tmp_path):
    """``python -m deepmerge_tpu_torch --device cpu train --epochs 2
    --max-steps 2`` at the tiny size writes a checkpoint per epoch and the
    loss files."""
    small = ["model.embed_dim=64", "model.depth=1,1,1", "model.num_heads=4",
             "model.out_dim=16", "model.dtype=float32",
             "model.input_image_scales=16,32,64", "data.patch_sizes=16,32,64",
             "data.batch_size=8", "data.max_window=128",
             "train.checkpoint_every=1",
             f"train.checkpoint_dir={tmp_path / 'ck'}",
             f"train.log_dir={tmp_path / 'logs'}"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "deepmerge_tpu_torch", "--device", "cpu",
         "train", "--epochs", "2", "--max-steps", "2", *small],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "epoch 2/2" in out.stdout
    ckpts = sorted(os.listdir(tmp_path / "ck"))
    assert len(ckpts) == 2 and ckpts[-1].endswith("_epoch0002")
    with open(tmp_path / "ck" / ckpts[-1] / "meta.json") as f:
        assert json.load(f)["step"] == 4
    (log,) = os.listdir(tmp_path / "logs")
    with open(tmp_path / "logs" / log / "epoch_loss.txt") as f:
        losses = [float(x) for x in f.read().split()]
    assert len(losses) == 2 and np.isfinite(losses).all()
