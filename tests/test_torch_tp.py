"""The port's tensor parallelism (``parallel.shard_params``, a model axis
above 1) on the CPU, against the JAX package and the port's single-device
paths.

One spawn of four gloo ranks (``tests/torch_dist_worker.py``, job ``tp``)
holds every case, on a 1x4 and a 2x2 (data x model) mesh of the tiny v3
(float32, 4 heads: one or two a rank) on JAX's initial parameters moved by
seeded noise, so that every bias and the bias tables are nonzero:

* the forward of ``S2Former(cfg, mesh)`` within ``atol=1e-4`` of the JAX
  package's replicated ``model.apply``, ``tests/test_sharding.py``'s bar
  for its TP forward, reached here without JAX's eight-device mesh
  [measured 3.6e-7];
* each rank's slices: qkv's rows the q, k and v rows of its own heads, the
  bias table its heads' columns, proj's and fc2's inputs and fc1's outputs
  its contiguous part; ``gather_params`` gives back the whole reference
  layout exactly;
* one DP x TP training step (as ``__graft_entry__.py``'s) at lr 1e-4: its
  loss within ``rtol=1e-4`` of the JAX package's single-device step on the
  same batch and weights (test_sharding.py's bar for its DP step) [1.7e-7],
  and within 1e-5 of the port's single-device step [8.6e-8];
  ``gather_params`` of the updated weights against that step's, as
  ``tests/test_torch_dp_train.py`` holds its data-parallel step: each
  tensor's RMS error within 1e-4 of its RMS [9.6e-6] off the entries whose
  gradient is zero by symmetry, and every entry within twice the learning
  rate. Adam's first step moves an entry by about the learning rate
  whatever its gradient's size, so an entry whose gradient is near zero
  moves by a visible share of it when its sum runs in another order. The
  same with dropout (0.1 on the activations, the attention and the MLP's
  hidden units, the masks the single-device model's cut to each rank's
  slices) [loss 8.4e-8, weights 2.8e-6], against the port's single-device
  step only (JAX's masks come from other random bits);
* the replicated parameters bit-identical across each model group, the
  sliced ones across each data group;
* a quantized model refused by name.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.train import loop as jloop
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from deepmerge_tpu_torch.parallel.mesh import _TP_SPLITS
from deepmerge_tpu_torch.train import loop as tloop
from tests.test_torch_dp_train import _symmetric
from tests.torch_dist_worker import _torch_batch, run_ranks

TINY = ModelConfig(variant="v3", input_image_scales=(16, 32, 64), cube=8,
                   embed_dim=64, depth=(2, 1, 1), num_heads=4, out_dim=32,
                   dtype="float32")
DROPOUT = dataclasses.replace(TINY, drop_ratio=0.1, attn_drop_ratio=0.1)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
PAIRS = 8
TOL_FORWARD = 1e-4
TOL_LOSS_JAX = 1e-4
TOL_STEP = 1e-5
TOL_STEP_RMS = 1e-4
LR = 1e-4


def _cfg(mcfg):
    return Config(model=mcfg, data=DataConfig(patch_sizes=(16, 32, 64)),
                  train=TrainConfig(lr=LR))


def _batch(rs, mcfg):
    scales = mcfg.input_image_scales
    return {
        "left_patches": tuple(rs.rand(PAIRS, s, s, 3).astype(np.float32)
                              for s in scales),
        "right_patches": tuple(rs.rand(PAIRS, s, s, 3).astype(np.float32)
                               for s in scales),
        "left_designed": rs.rand(PAIRS, 19).astype(np.float32),
        "right_designed": rs.rand(PAIRS, 19).astype(np.float32),
        "flag": (rs.rand(PAIRS) > 0.5).astype(np.float32),
    }


@pytest.fixture(scope="module")
def case():
    """The JAX model, its parameters moved by seeded noise, the port's
    state dict of them, the inputs and the JAX references."""
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(TINY))
    model = build_model(jcfg)
    params = init_params(model, jax.random.key(0))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree.map(lambda p: np.asarray(p) + rs.normal(
        0, 0.02, np.shape(p)).astype(np.float32), params)
    patches = tuple(rs.rand(4, s, s, 3).astype(np.float32)
                    for s in TINY.input_image_scales)
    designed = rs.rand(4, 19).astype(np.float32)
    forward = np.asarray(model.apply(
        {"params": jax.tree.map(jnp.asarray, params)}, patches, designed,
        False))
    batch = _batch(rs, TINY)
    jc = jconfig.Config(model=jcfg, data=jconfig.DataConfig(
        patch_sizes=(16, 32, 64)), train=jconfig.TrainConfig(lr=LR))
    jstate = jloop.create_train_state(model, jc, jax.random.key(0), 2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jstate.replace(params=jp, opt_state=jstate.tx.init(jp))
    _, m = jloop.make_train_step(model, jc)(
        jstate, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    return dict(sd=state_dict_from_flax(params, TINY), patches=patches,
                designed=designed, forward=forward, batch=batch,
                jax_loss=float(m["loss"]))


@pytest.fixture(scope="module")
def single(case):
    """The port's single-device step on the same weights and batch, with
    and without dropout."""
    out = {}
    for run, mcfg in (("plain", TINY), ("dropout", DROPOUT)):
        cfg = _cfg(mcfg)
        state = tloop.create_train_state(cfg, 2, case["sd"], device="cpu")
        state, m = tloop.make_train_step(cfg)(state,
                                              _torch_batch(case["batch"]))
        out[run] = dict(loss=float(m["loss"]), state={
            k: v.detach().clone() for k, v in
            state.model.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, case):
    spec = dict(tp=dict(
        meshes=MESHES, mcfg=TINY, state_dict=case["sd"],
        patches=case["patches"], designed=case["designed"],
        batch=case["batch"],
        train={"plain": _cfg(TINY), "dropout": _cfg(DROPOUT)}))
    return run_ranks("tp", 4, spec, tmp_path_factory.mktemp("tp"))


def _sliced(name):
    return any(name.endswith(s) for s, _, _ in _TP_SPLITS)


@pytest.mark.parametrize("mesh", MESHES)
def test_forward_matches_jax_replicated(ranks, case, mesh):
    for out in ranks:
        np.testing.assert_allclose(out["tp"][mesh]["forward"],
                                   case["forward"], atol=TOL_FORWARD)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_heads(ranks, case, mesh):
    """qkv's rows are the q, k and v rows of the rank's heads; the bias
    table, proj, fc1 and fc2 its heads' or hidden units' slices."""
    sd, c, heads = case["sd"], TINY.embed_dim, TINY.num_heads
    n = MESHES[mesh][1]
    d, hidden = c // heads, int(c * TINY.mlp_ratio)
    for out in ranks:
        m = out["tp"][mesh]["coords"]["model"]
        mine = range(m * heads // n, (m + 1) * heads // n)
        got = out["tp"][mesh]["slices"]
        w = sd["blocks0.0.attn.qkv.weight"].reshape(3, heads, d, c)
        b = sd["blocks0.0.attn.qkv.bias"].reshape(3, heads, d)
        torch.testing.assert_close(got["blocks0.0.attn.qkv.weight"],
                                   w[:, mine].reshape(-1, c), rtol=0, atol=0)
        torch.testing.assert_close(got["blocks0.0.attn.qkv.bias"],
                                   b[:, mine].reshape(-1), rtol=0, atol=0)
        cols = slice(mine[0] * d, (mine[-1] + 1) * d)
        hid = slice(m * hidden // n, (m + 1) * hidden // n)
        for name, want in (
                ("attn.relative_position_bias_table",
                 sd["blocks0.0.attn.relative_position_bias_table"][:, mine]),
                ("attn.proj.weight", sd["blocks0.0.attn.proj.weight"][:, cols]),
                ("mlp.fc1.weight", sd["blocks0.0.mlp.fc1.weight"][hid]),
                ("mlp.fc1.bias", sd["blocks0.0.mlp.fc1.bias"][hid]),
                ("mlp.fc2.weight", sd["blocks0.0.mlp.fc2.weight"][:, hid]),
                ("attn.proj.bias", sd["blocks0.0.attn.proj.bias"]),
                ("mlp.fc2.bias", sd["blocks0.0.mlp.fc2.bias"])):
            torch.testing.assert_close(got[f"blocks0.0.{name}"], want,
                                       rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_gather_params_inverts_shard_params(ranks, case, mesh):
    for out in ranks:
        got = out["tp"][mesh]["gathered"]
        assert set(got) == set(case["sd"])
        for k, want in case["sd"].items():
            torch.testing.assert_close(got[k], want, rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_loss_matches_jax(ranks, case, single, mesh):
    want = case["jax_loss"]
    assert abs(single["plain"]["loss"] - want) <= TOL_LOSS_JAX * abs(want)
    for out in ranks:
        got = out["tp"][mesh]["train"]["plain"]["loss"]
        assert abs(got - want) <= TOL_LOSS_JAX * abs(want), (got, want)


@pytest.mark.parametrize("run", ["plain", "dropout"])
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_single_device(ranks, case, single, mesh, run):
    """The loss, and the gathered weights after the step, against the
    port's single-device step."""
    want = single[run]
    moved = sum(not torch.equal(want["state"][k], v)
                for k, v in case["sd"].items())
    assert moved > 10
    for out in ranks:
        got = out["tp"][mesh]["train"][run]
        assert abs(got["loss"] - want["loss"]) <= TOL_STEP * abs(
            want["loss"])
        for k, w in want["state"].items():
            g = got["gathered"][k]
            if not w.is_floating_point():
                torch.testing.assert_close(g, w, rtol=0, atol=0)
                continue
            assert float((g - w).abs().max()) <= 2 * LR, k
            keep = ~torch.from_numpy(_symmetric(k, w))
            if keep.any():
                g, w = g[keep], w[keep]
                rms = lambda t: float(t.square().mean().sqrt())
                assert rms(g - w) <= TOL_STEP_RMS * rms(w), (k, rms(g - w))


@pytest.mark.parametrize("mesh", MESHES)
def test_parameters_agree_across_the_mesh(ranks, mesh):
    """Replicated parameters bit-identical on every rank (the model group's
    by f's reduced gradients, the data group's by the gradient SUM);
    sliced ones on the ranks of a data group."""
    outs = [o["tp"][mesh] for o in ranks]
    for run in ("plain", "dropout"):
        for k, v in outs[0]["train"][run]["state"].items():
            for o in outs[1:]:
                if _sliced(k) and o["coords"]["model"] != \
                        outs[0]["coords"]["model"]:
                    continue
                torch.testing.assert_close(o["train"][run]["state"][k], v,
                                           rtol=0, atol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_quantized_model_refused(ranks, mesh):
    for out in ranks:
        msg = out["tp"][mesh]["quantized"]
        assert msg is not None and "tensor parallelism" in msg \
            and "B6" in msg


def test_ranks_import_no_jax(ranks):
    for out in ranks:
        assert out["modules"] == []
