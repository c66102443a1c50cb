"""The legacy nets, their harness and the triplet sampler of the PyTorch
port (``models/legacy.py``, ``train/legacy_harness.py``,
``train/sampler.TripletSampler``) against the JAX package's, on the CPU.

Weights go JAX init (jitted) plus seeded noise (so that every bias, the
non-local block's zero-initialised ``w_z`` and the GRU cells' six denses
are nonzero) → numpy → ``legacy_state_dict_from_flax``; inputs come from a
numpy seed. Tolerances: the nets in float32 within 1e-5 of max|JAX| (sums
in other orders; measured ≤ 3e-7, the GRU's 4 layers ≤ 3e-7 of its
output); ``train_mlp``'s epoch loss within 1e-4 of the JAX package's
(which logs it at 4 decimals; same weights, batches and Adam). The GRU's
dropout stream cannot match JAX's, so ``train_gru`` is held by its
accuracy, as the JAX package's own test holds it. Patches are bit-exact,
at crop 32 and at the default crop, 224 (where the exact path's column
sums can land on rounding ties, ``tests/patch_ties.py``; none does on this
module's scene).
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.config import DataConfig as JDataConfig
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.models import legacy as jl
from deepmerge_tpu.train import legacy_harness as jh
from deepmerge_tpu.train.sampler import TripletSampler as JTripletSampler
from deepmerge_tpu_torch.compat.weights import legacy_state_dict_from_flax
from deepmerge_tpu_torch.config import DataConfig
from deepmerge_tpu_torch.geodata.synthetic import generate_scene
from deepmerge_tpu_torch.models import legacy as tl
from deepmerge_tpu_torch.train import legacy_harness as th
from deepmerge_tpu_torch.train.sampler import TripletSampler
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
DATA = dict(patch_sizes=(16, 32, 64), max_window=128, batch_size=8)
SCENE = dict(h=128, w=128, n_regions=16, n_objects=4, seed=5,
             points_per_region=2)


def _carried(jmodule, tmodule, *args, seed=0, as_nonlocal=False):
    """JAX init on ``args`` plus N(0, 0.05) noise on every leaf, loaded
    into ``tmodule``; returns the flax parameters. ``as_nonlocal``: a
    non-local block alone, carried as a network's ``nonlocal``."""
    init = jax.jit(jmodule.init)(jax.random.key(seed), *args)
    rs = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rs.standard_normal(np.shape(a)).astype(np.float32) * 0.05,
        init["params"])
    tree = {"vgg16": {}, "nonlocal": params} if as_nonlocal else params
    tmodule.load_state_dict(legacy_state_dict_from_flax(tree), strict=True)
    return params


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_mlp_against_jax():
    x = np.random.RandomState(0).rand(4, 784).astype(np.float32)
    jm, tm = jl.MLP(), tl.MLP()
    params = _carried(jm, tm, x)
    want = jax.jit(jm.apply)({"params": params}, x)
    got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):  # logits, penultimate
        _close(g, w)


def test_gru_attention_against_jax():
    """4 bidirectional layers, the backward one in the input's order; every
    dense of every flax ``GRUCell`` (ir, iz, in, hr, hz, hn) with nonzero
    weights and, where flax has one, a nonzero bias."""
    x = np.random.RandomState(1).rand(3, 6, 7).astype(np.float32)
    jm, tm = jl.GRUAttention(), tl.GRUAttention(in_dim=7)
    params = _carried(jm, tm, x, seed=1)
    assert all(np.abs(params[f"GRUCell_{i}"][g]["bias"]).min() > 0
               for i in range(8) for g in ("ir", "iz", "in", "hn"))
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)({"params": params}, x))
    # flax has no hidden bias on the r and z gates: torch's stays zero
    # under training too (its gradient is masked)
    tm(torch.from_numpy(x), True, torch.Generator().manual_seed(0)).sum() \
        .backward()
    for name, p in tm.rnn.named_parameters():
        if name.startswith("bias_hh"):
            assert not p.grad[:160].any() and p.grad[160:].any()


def test_non_local_block_against_jax():
    """NHWC in JAX, NCHW in the port; ``w_z`` made nonzero."""
    x = np.random.RandomState(2).standard_normal((2, 4, 5, 8)).astype(
        np.float32)
    jm, holder = jl.NonLocalBlock2D(8), torch.nn.Module()
    holder.add_module("nonlocal", tl.NonLocalBlock2D(8))
    params = _carried(jm, holder, x, seed=2, as_nonlocal=True)
    got = getattr(holder, "nonlocal")(
        torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jax.jit(jm.apply)({"params": params}, x))


def test_spatially_memorized_network_against_jax():
    """VGG16 + non-local + GAP + reduce + L2 norm on 32² crops, then the
    attention pooling over three context embeddings."""
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    jm = jl.SpatiallyMemorizedNetwork(reduced_size=64)
    tm = tl.SpatiallyMemorizedNetwork(reduced_size=64)
    params = _carried(jm, tm, x, seed=3)
    want = jax.jit(jm.apply)({"params": params}, x)
    got = tm(torch.from_numpy(x))
    _close(got, want)
    ctx = np.random.RandomState(4).standard_normal((2, 3, 64)).astype(
        np.float32)
    _close(tm.pool_contexts(torch.from_numpy(ctx)),
           jm.apply({"params": params}, jnp.asarray(ctx),
                    method=jm.pool_contexts))


def test_synthetic_digits_equal():
    for kw in (dict(), dict(n=100, seed=3, n_classes=4)):
        for a, b in zip(th.synthetic_digits(**kw), jh.synthetic_digits(**kw)):
            np.testing.assert_array_equal(a, b)


def test_train_mlp_losses_against_jax(monkeypatch):
    """One epoch of 8 Adam steps from the JAX package's initial weights
    (the harness's model built with them) on the same shuffled batches:
    the epoch's mean loss equal to the JAX package's logged one, and the
    same accuracy."""
    x, y = th.synthetic_digits(n=512)
    logs = []
    _, jacc = jh.train_mlp(x, y, epochs=1, batch_size=64,
                           log_fn=logs.append)
    want = float(re.search(r"loss=([0-9.]+)", logs[0]).group(1))
    init = jl.MLP(num_classes=10).init(jax.random.key(0),
                                      jnp.zeros((1, 784)))["params"]
    sd = legacy_state_dict_from_flax(jax.tree.map(np.asarray, init))

    def jax_initialized(*args, **kwargs):
        model = tl.MLP(*args, **kwargs)
        model.load_state_dict(sd, strict=True)
        return model

    monkeypatch.setattr(th, "MLP", jax_initialized)
    _, acc, losses = th.train_mlp(x, y, epochs=1, batch_size=64,
                                  device="cpu", log_fn=lambda *_: None)
    assert abs(losses[0] - want) <= 1e-4
    assert acc == pytest.approx(jacc, abs=2 / len(x))


def test_train_gru_accuracy_rises():
    x, y = th.synthetic_digits(n=256, seed=1)
    model, acc, losses = th.train_gru(x, y, epochs=2, batch_size=64,
                                      device="cpu", log_fn=lambda *_: None)
    assert acc > 0.3 and losses[1] < losses[0]


def test_trainers_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (th.train_mlp, th.train_gru):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn(*th.synthetic_digits(n=64), epochs=1)


def test_triplet_sampler_needs_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # window-cap clamping note
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TripletSampler(generate_scene(**SCENE), DataConfig(**DATA))


@pytest.fixture(scope="module", params=[32, 224])
def triplet_samplers(request):
    """Both packages' samplers at crop 32 and at the default crop, 224."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # window-cap clamping note
        ours = TripletSampler(generate_scene(**SCENE), DataConfig(**DATA),
                              crop_size=request.param, device="cpu")
        theirs = JTripletSampler(jsynthetic.generate_scene(**SCENE),
                                 JDataConfig(**DATA), crop_size=request.param)
    return ours, theirs


def test_triplet_batches_equal_jax(triplet_samplers):
    """Two epochs' batches: the same draws (the same object of every point
    picked), the same 3-context patches bit for bit."""
    ours, theirs = triplet_samplers
    crop = ours.crop_size
    np.testing.assert_array_equal(ours.point_object, theirs.point_object)
    for seed in (0, 1):
        got = list(ours.epoch_batches(seed, 4))
        want = list(theirs.epoch_batches(seed, 4))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("anchor", "positive", "negative"):
                assert len(g[key]) == 3
                for a, b in zip(g[key], w[key]):
                    assert a.shape == (4, crop, crop, 3)
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_triplet_test_object_equals_jax(triplet_samplers):
    ours, theirs = triplet_samplers
    region = int(ours.scene.rag.edges[0, 0])
    for pad_to in (None, 4):
        got = ours.test_object(region, pad_to=pad_to)
        want = theirs.test_object(region, pad_to=pad_to)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert got[2:4] == want[2:4]
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a.numpy(), b)
        if pad_to:
            np.testing.assert_array_equal(got[4], want[4])
