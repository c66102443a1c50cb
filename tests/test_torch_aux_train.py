"""Training v4 and v5 (the aux heads, their BatchNorm and the aux losses),
dropout, drop path and Dropout2d, and v4 checkpoints of the PyTorch port,
on the CPU.

* The tiny v4 and v5 trainers against the JAX package's scanned epoch,
  ``train.aux_weights=(0.1, 0.2)``, ``STEPS`` float32 steps from the same
  weights on the same epoch arrays at the reference's learning rate 1e-4,
  across both schedule boundaries, with the aux heads' Dropout2d off on
  both sides (its masks come from different generators): every loss within
  1e-5 relative [measured ≤ 3.6e-7] and the BatchNorm running mean and
  variance within 1e-6 of JAX's ``batch_stats`` [≤ 3e-7]. (At 1e-3 Adam
  turns the rounding noise of near-zero gradients, which differs between
  the packages, into 1.5e-6 of v5's statistics within the six steps.)
* Dropout, drop path and Dropout2d, whose masks cannot be JAX's (its
  ``fold_in`` streams are not torch's), by distribution: the kept share
  within five standard deviations of the binomial's, the kept values
  divided by the keep probability, whole channels per sample for Dropout2d
  and whole samples for drop path; a rate of 0 draws nothing and changes
  nothing.
* A port checkpoint of a trained v4 loads into the JAX package through
  ``load_torch_checkpoint`` with its BatchNorm statistics, and JAX's
  export of those variables loads back bit for bit.
"""

import dataclasses
import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.compat.torch_export import flax_to_torch_state_dict
from deepmerge_tpu.compat.torch_import import load_torch_checkpoint
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.models import s2former as jsm
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
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import S2Former
from deepmerge_tpu_torch.train import checkpoint as tckpt
from deepmerge_tpu_torch.train import loop as tloop
from deepmerge_tpu_torch.train import sampler as tsampler

TINY = dict(input_image_scales=(16, 32, 64), cube=8, embed_dim=64,
            depth=(1, 1, 1), num_heads=4, out_dim=16, dtype="float32")
DATA = dict(patch_sizes=(16, 32, 64), max_window=128, batch_size=8)
TRAIN = dict(lr=1e-4, lr_milestones=(1, 2), aux_weights=(0.1, 0.2))
SCENE = dict(h=128, w=128, n_regions=24, n_objects=4, points_per_region=2,
             seed=3)
STEPS = 6
LOSS_TOL = 1e-5
BN_TOL = 1e-6


def _cfgs(variant, **model_kw):
    kw = dict(TINY, variant=variant, **model_kw)
    return (Config(model=ModelConfig(**kw), data=DataConfig(**DATA),
                   train=TrainConfig(**TRAIN)),
            jconfig.Config(model=jconfig.ModelConfig(**kw),
                           data=jconfig.DataConfig(**DATA),
                           train=jconfig.TrainConfig(**TRAIN)))


@pytest.fixture(scope="module")
def scenes():
    return generate_scene(**SCENE), jsynthetic.generate_scene(**SCENE)


def _fused_samplers(scenes, cfg, jcfg):
    scene, jscene = scenes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # window-cap clamping note
        ours = tsampler.FusedPairSampler(scene, *make_training_pairs(scene),
                                         cfg.data)
        theirs = jsampler.FusedPairSampler(
            jscene, *jsynthetic.make_training_pairs(jscene), jcfg.data)
    return ours, theirs


def _bn_stats(model):
    return {f"{name}/{k}": getattr(getattr(model, name).aux[1], buf)
            .detach().numpy().copy()
            for name in ("aux0", "aux1")
            for k, buf in (("mean", "running_mean"), ("var", "running_var"))}


@pytest.mark.parametrize("variant", ["v4", "v5"])
def test_aux_trainer_matches_jax(variant, scenes, monkeypatch):
    """The scanned epoch with aux losses: JAX's loss trajectory and
    BatchNorm running statistics."""
    monkeypatch.setattr(jsm, "AuxBlock",
                        functools.partial(jsm.AuxBlock, drop=0.0))
    monkeypatch.setattr(s2former, "AuxBlock",
                        functools.partial(s2former.AuxBlock, drop=0.0))
    cfg, jcfg = _cfgs(variant)
    ours, theirs = _fused_samplers(scenes, cfg, jcfg)
    spe = len(theirs) // DATA["batch_size"]
    model = jsm.build_model(jcfg.model)
    jstate = jloop.create_train_state(model, jcfg, jax.random.key(0), spe)
    params = jax.tree.map(np.asarray, jstate.params)
    stats0 = jax.tree.map(np.asarray, jstate.batch_stats)
    arrays = theirs.epoch_arrays(11, DATA["batch_size"])
    arrays = tuple(jnp.concatenate([a, a])[:STEPS] for a in arrays)
    jepoch = jloop.make_scanned_epoch(model, jcfg, theirs.device_scene)
    jstate, want = jepoch(jstate, *arrays, jax.random.key(1))
    want_bs = jax.tree.map(np.asarray, jstate.batch_stats)

    state = tloop.create_train_state(
        cfg, 2, state_dict=state_dict_from_flax(params, cfg.model, stats0),
        device="cpu")
    state.lr = tloop.lr_schedule(cfg, spe)
    arrays = ours.epoch_arrays(11, DATA["batch_size"])
    arrays = tuple(torch.cat([a, a])[:STEPS] for a in arrays)
    state, got = tloop.make_scanned_epoch(cfg, ours.device_scene)(
        state, *arrays)
    assert state.step == STEPS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL)
    stats = _bn_stats(state.model)
    for key, value in stats.items():
        name, k = key.split("/")
        start = stats0[name]["bn"][k]
        assert np.abs(want_bs[name]["bn"][k] - start).max() > 1e-4, key
        np.testing.assert_allclose(value, want_bs[name]["bn"][k], rtol=0,
                                   atol=BN_TOL, err_msg=key)


def test_aux_outputs_only_in_training():
    cfg, _ = _cfgs("v4")
    model = S2Former(s2former.training_model(cfg))
    rs = np.random.default_rng(0)
    patches = [torch.from_numpy(rs.random((4, s, s, 3), dtype=np.float32))
               for s in TINY["input_image_scales"]]
    designed = torch.from_numpy(rs.standard_normal((4, 19)).astype(
        np.float32))
    g = torch.Generator().manual_seed(0)
    out, aux0, aux1 = model(patches, designed, train=True, generator=g)
    assert out.shape == aux0.shape == aux1.shape == (4, TINY["out_dim"])
    stats = _bn_stats(model)
    with torch.no_grad():
        served = model(patches, designed)
    assert isinstance(served, torch.Tensor) and served.shape == out.shape
    for key, value in _bn_stats(model).items():  # inference leaves them
        np.testing.assert_array_equal(value, stats[key])


# ------------------------------------------------------------- dropout


def _within_binomial(kept, n, keep):
    sd = np.sqrt(n * keep * (1 - keep))
    return abs(kept - n * keep) <= 5 * sd


def test_dropout_keeps_its_share_and_scales():
    x = torch.full((400, 500), 2.0)
    y = s2former.dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = y != 0
    assert _within_binomial(int(kept.sum()), x.numel(), 0.7)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.7))


def test_dropout2d_masks_whole_channels_per_sample():
    """The aux heads' Dropout2d: one draw per (sample, channel) of NHWC."""
    b, h, w, c = 64, 7, 7, 96
    x = torch.ones((b, h, w, c))
    y = s2former.dropout(x, 0.3, torch.Generator().manual_seed(2),
                         shape=(b, 1, 1, c))
    per_channel = y.reshape(b, h * w, c)
    assert bool((per_channel == per_channel[:, :1]).all())
    kept = per_channel[:, 0] != 0
    assert _within_binomial(int(kept.sum()), b * c, 0.7)


def test_drop_path_masks_whole_samples():
    x = torch.ones((2000, 13, 8))
    y = s2former.drop_path(x, 0.25, torch.Generator().manual_seed(3))
    per_sample = y.reshape(2000, -1)
    assert bool((per_sample == per_sample[:, :1]).all())
    kept = per_sample[:, 0] != 0
    assert _within_binomial(int(kept.sum()), 2000, 0.75)
    torch.testing.assert_close(per_sample[kept],
                               torch.full_like(per_sample[kept], 1 / 0.75))


def test_zero_rates_draw_nothing_and_change_nothing():
    g = torch.Generator().manual_seed(4)
    before = g.get_state()
    x = torch.randn((5, 6), generator=torch.Generator().manual_seed(5))
    assert s2former.dropout(x, 0.0, g) is x
    assert s2former.drop_path(x, 0.0, g) is x
    cfg, _ = _cfgs("v3")
    model = S2Former(s2former.training_model(cfg))
    rs = np.random.default_rng(1)
    patches = [torch.from_numpy(rs.random((2, s, s, 3), dtype=np.float32))
               for s in TINY["input_image_scales"]]
    designed = torch.from_numpy(rs.standard_normal((2, 19)).astype(
        np.float32))
    got = model(patches, designed, train=True, generator=g)
    assert torch.equal(g.get_state(), before)
    torch.testing.assert_close(got, model(patches, designed, train=True),
                               rtol=0, atol=0)


def test_training_with_dropout_is_seeded_by_step(scenes):
    """v1 with dropout, attention dropout and drop path (the attention then
    runs unfused) trains; the masks follow (seed, step): the same start
    gives the same losses, another seed others."""
    cfg = Config(
        model=ModelConfig(**dict(TINY, variant="v1",
                                 input_image_scales=(16, 32, 64, 32),
                                 depth=(3,), drop_ratio=0.1,
                                 attn_drop_ratio=0.1, drop_path_ratio=0.2)),
        data=DataConfig(patch_sizes=(16, 32, 64, 32), max_window=128,
                        batch_size=8),
        train=TrainConfig(**TRAIN))
    scene, _ = scenes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sampler = tsampler.FusedPairSampler(
            scene, *make_training_pairs(scene), cfg.data)
    arrays = tuple(a[:2] for a in sampler.epoch_arrays(0, 8))
    epoch_fn = tloop.make_scanned_epoch(cfg, sampler.device_scene)
    start = tloop.create_train_state(cfg, 2, device="cpu").model.state_dict()

    def run(seed):
        c = cfg.replace(train=dataclasses.replace(cfg.train, seed=seed))
        state = tloop.create_train_state(c, 2, state_dict=start,
                                         device="cpu")
        return epoch_fn(state, *arrays)[1]

    a, b, other = run(0), run(0), run(7)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, other)


# ---------------------------------------------------------- checkpoint


def test_v4_checkpoint_crosses_to_jax_and_back(tmp_path, scenes):
    """Two steps move v4's BatchNorm statistics; the saved ``.pth`` loads
    into the JAX package with them, and JAX's export of the result loads
    back into the port equal to the trained state."""
    cfg, jcfg = _cfgs("v4")
    ours, _ = _fused_samplers(scenes, cfg, jcfg)
    state = tloop.create_train_state(cfg, 2, device="cpu")
    start = _bn_stats(state.model)
    arrays = tuple(a[:2] for a in ours.epoch_arrays(0, DATA["batch_size"]))
    state, _ = tloop.make_scanned_epoch(cfg, ours.device_scene)(state,
                                                                *arrays)
    path = tckpt.CheckpointManager(str(tmp_path), cfg).save(state, 0)
    variables = load_torch_checkpoint(os.path.join(path, tckpt.PAYLOAD), jcfg)
    for key, value in _bn_stats(state.model).items():
        name, k = key.split("/")
        assert np.abs(value - start[key]).max() > 1e-4, key
        np.testing.assert_array_equal(
            np.asarray(variables["batch_stats"][name]["bn"][k]), value)
    back = flax_to_torch_state_dict(variables, jcfg.model)
    model = S2Former(cfg.model)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in back.items()}, strict=True)
    trained = state.model.state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0, msg=k)
