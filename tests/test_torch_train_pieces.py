"""The pieces of the PyTorch port's training slice against the JAX package,
on the CPU: the losses, the learning-rate schedule, Adam's update, the
samplers, the checkpoint round trip and the rules of ``training_model``.
Fixtures and helpers are ``tests/test_torch_train.py``'s (the tiny v3, its
scene in each package, JAX's initial weights).

Tolerances (measured in brackets):
* losses: 1e-6 relative — the same float32 sums in other orders [≤ 1e-7];
* the schedule, the sampler arrays and patches: exact;
* Adam updates: the parameters within 1e-4 of the update's size (1e-8
  here, about five float32 ulps of the parameters) — optax and torch
  evaluate the same formula in another order, and the sums with the
  parameters round [3.7e-9];
* a restored checkpoint: exact.
"""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepmerge_tpu.train import loop as jloop
from deepmerge_tpu.train import losses as jlosses
from deepmerge_tpu.train import sampler as jsampler
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.models.s2former import S2Former, training_model
from deepmerge_tpu_torch.train import checkpoint as tckpt
from deepmerge_tpu_torch.train import loop as tloop
from deepmerge_tpu_torch.train import losses as tlosses
from deepmerge_tpu_torch.train import sampler as tsampler
from tests.test_torch_train import (  # noqa: F401 (fixtures)
    DATA,
    TINY,
    _cfgs,
    _np,
    _samplers,
    flax_params,
    scenes,
)


# ------------------------------------------------------------ loss, lr, Adam


@pytest.mark.parametrize("margin", [1.0, 0.3])
def test_contrastive_pair_loss_matches_jax(margin):
    rs = np.random.default_rng(0)
    a, b = (rs.standard_normal((32, 16)).astype(np.float32) * 0.3
            for _ in range(2))
    flag = (rs.random(32) < 0.5).astype(np.float32)
    want = float(jlosses.contrastive_pair_loss(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(flag), margin))
    got = float(tlosses.contrastive_pair_loss(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(flag),
        margin))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["class_loss", "multi_loss",
                                  "triplet_loss"])
def test_other_losses_match_jax(name):
    rs = np.random.default_rng(2)
    emb = [rs.standard_normal((16, 8)).astype(np.float32) * 0.4
           for _ in range(3)]
    logits = [rs.standard_normal((16, 5)).astype(np.float32)
              for _ in range(2)]
    labels = [rs.integers(0, 5, 16) for _ in range(2)]
    flag = (rs.random(16) < 0.5).astype(np.float32)
    args = {
        "class_loss": (logits[0], labels[0], logits[1], labels[1]),
        "multi_loss": (emb[0], emb[1], flag, logits[0], labels[0],
                       logits[1], labels[1]),
        "triplet_loss": tuple(emb),
    }[name]
    want = float(getattr(jlosses, name)(*map(jnp.asarray, args)))
    got = float(getattr(tlosses, name)(*map(torch.from_numpy, args)))
    assert got == pytest.approx(want, rel=1e-6)


def test_lr_schedule_exact_at_and_around_boundaries():
    """optax's piecewise-constant values, bit for bit, at every step from 0
    past the last boundary, with the reference milestones (40, 80) and
    with boundaries 2 and 4 (1e-4, 1e-4, 2e-5, 2e-5, 4e-6, ...)."""
    for milestones, spe in (((40, 80), 7), ((1, 2), 2)):
        cfg, jcfg = _cfgs(lr=1e-4, lr_milestones=milestones)
        ours = tloop.lr_schedule(cfg, spe)
        theirs = jloop.lr_schedule(jcfg, spe)
        last = milestones[-1] * spe
        for step in range(last + 3):
            assert ours(step) == float(theirs(step)), step
    sched = tloop.lr_schedule(_cfgs(lr=1e-4, lr_milestones=(1, 2))[0], 2)
    lr0, g = np.float32(1e-4), np.float32(0.2)
    want = [lr0, lr0, g * lr0, g * lr0] + [g * (g * lr0)] * 3
    assert [sched(s) for s in range(7)] == [float(v) for v in want]
    assert sched(2) == pytest.approx(2e-5) and sched(4) == pytest.approx(4e-6)


def test_one_adam_update_matches_optax():
    """Two updates of ``torch.optim.Adam`` against ``optax.adam`` (b1 0.9,
    b2 0.999, eps 1e-8) on the same parameters and gradients."""
    rs = np.random.default_rng(1)
    p0 = rs.standard_normal((40, 30)).astype(np.float32) * 0.02
    grads = [rs.standard_normal((40, 30)).astype(np.float32) * s
             for s in (1e-3, 5e-2)]
    tx = optax.adam(1e-4)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([w], lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        opt.step()
        want, got = np.asarray(params), w.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)
    assert np.abs(want - p0).max() > 1.9e-4  # two updates of ~lr each


# ------------------------------------------------------------- samplers


def test_fused_epoch_arrays_bit_identical(scenes):
    ours, theirs = _samplers(scenes)
    assert len(ours) == len(theirs)
    for seed in (0, 100003 + 1):
        got = ours.epoch_arrays(seed, DATA["batch_size"])
        want = theirs.epoch_arrays(seed, DATA["batch_size"])
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the per-batch form gives the same rows as the whole-epoch arrays
    arrays = ours.epoch_arrays(7, DATA["batch_size"])
    for i, batch in enumerate(ours.epoch_batches(7, DATA["batch_size"])):
        for key, a in zip(("centers", "scales", "designed", "flag"), arrays):
            np.testing.assert_array_equal(_np(batch[key]), _np(a[i]))


def test_pair_sampler_epoch_batches_bit_identical(scenes):
    """Host-materialized batches: patches (K1's plain version and the
    exact resize), designed vectors and flags bit-identical."""
    ours, theirs = _samplers(scenes, "PairSampler")
    n = 0
    for got, want in zip(ours.epoch_batches(3, DATA["batch_size"]),
                         theirs.epoch_batches(3, DATA["batch_size"])):
        for side in ("left", "right"):
            for g, w in zip(got[f"{side}_patches"], want[f"{side}_patches"]):
                np.testing.assert_array_equal(_np(g), np.asarray(w))
            np.testing.assert_array_equal(_np(got[f"{side}_designed"]),
                                          np.asarray(want[f"{side}_designed"]))
        np.testing.assert_array_equal(_np(got["flag"]),
                                      np.asarray(want["flag"]))
        n += 1
    assert n == len(ours) // DATA["batch_size"] >= 2


def test_multi_scene_sampler_interleaves_like_jax(scenes):
    ours, theirs = _samplers(scenes, "PairSampler")
    got = tsampler.MultiScenePairSampler([ours, ours])
    want = jsampler.MultiScenePairSampler([theirs, theirs])
    assert len(got) == len(want)
    flags = lambda it: [_np(b["flag"]).tolist() for b in it]
    assert flags(got.epoch_batches(5, 8)) == flags(want.epoch_batches(5, 8))


# ------------------------------------------------- checkpoints and rules


def test_checkpoint_roundtrip_and_resume_rules(tmp_path, scenes,
                                               flax_params):
    """A checkpoint restores the parameters, the Adam moments and the step
    count; resuming at or past ``num_epochs`` raises, a plain restore does
    not; ``latest_path`` picks the newest epoch of this model."""
    cfg, _ = _cfgs(num_epochs=2, checkpoint_dir=str(tmp_path))
    ours, _ = _samplers(scenes)
    start = state_dict_from_flax(flax_params, cfg.model)
    state = tloop.create_train_state(cfg, 2, state_dict=start)
    epoch_fn = tloop.make_scanned_epoch(cfg, ours.device_scene)
    arrays = ours.epoch_arrays(0, DATA["batch_size"])
    state, _ = epoch_fn(state, *(a[:2] for a in arrays))
    mgr = tckpt.CheckpointManager(str(tmp_path), cfg)
    mgr.save(state, 0, 1.5)
    path = mgr.save(state, 1, 2.5)
    assert os.path.basename(path) == f"{cfg.model.name}_epoch0002"
    assert mgr.latest_path() == path
    payload = torch.load(os.path.join(path, tckpt.PAYLOAD),
                         weights_only=False)
    assert set(payload) == {"net", "optimizer", "epoch", "time", "scales",
                            "depth", "name"}
    fresh = tloop.create_train_state(cfg, 2, state_dict=start)
    fresh, epoch, elapsed = mgr.restore(fresh)
    assert (epoch, elapsed, fresh.step) == (2, 2.5, 2)
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    moments = lambda s: [t for st in s.optimizer.state.values()
                         for t in (st["exp_avg"], st["exp_avg_sq"])]
    assert moments(state)
    for a, b in zip(moments(state), moments(fresh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="num_epochs"):
        mgr.restore(fresh, for_resume=True)
    assert tckpt.should_checkpoint(4, cfg) and not tckpt.should_checkpoint(
        3, cfg)


def test_training_model_rules():
    cfg, _ = _cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q = cfg.replace(model=dataclasses.replace(
            cfg.model, quantize="w8a8", fused_stage_chain=True))
        mcfg = training_model(q)
        assert (mcfg.fused_block, mcfg.quantize, mcfg.fused_stage_chain,
                mcfg.chain_stage0) == (False, "", False, False)
        k5 = cfg.replace(train=dataclasses.replace(cfg.train,
                                                   fused_block=True))
        with pytest.raises(NotImplementedError, match="K5"):
            training_model(k5)
    # dropout, drop path and the unfused attention train (off the block
    # kernels, as the JAX package trains them); an unported variant raises
    for change in (dict(drop_ratio=0.1), dict(attn_drop_ratio=0.1),
                   dict(drop_path_ratio=0.1), dict(fused_attention=False)):
        ok = cfg.replace(model=dataclasses.replace(cfg.model, **change))
        assert training_model(ok) == dataclasses.replace(
            ok.model, fused_block=False, fused_stage_chain=False)
    bad = cfg.replace(model=dataclasses.replace(cfg.model, variant="vit"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        training_model(bad)
    # the inference model refuses a training forward: that is K5's path
    model = S2Former(cfg.model)
    patches = [torch.rand((2, s, s, 3)) for s in TINY["input_image_scales"]]
    with pytest.raises(NotImplementedError, match="K5"):
        model(patches, torch.rand((2, 19)), train=True)
