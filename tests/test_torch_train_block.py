"""The saved-activation training block of the PyTorch port (kernel K5's
plain version, its hand backward, the differentiable block and chain, and
the trainer with ``train.fused_block``) against the JAX package, on the
CPU, on the same numpy inputs. The JAX package's Pallas kernels run in
interpret mode, as its own tests run them.

Tolerances (measured in brackets):
* the training forward's five outputs: float32 within 2e-6 of max|JAX|
  [2.7e-7]; bf16 within 1e-2 [4.4e-3]: the same roundings at the same
  points, the sums in other orders, so an output may sit one bf16 ulp
  (2^-8 relative) apart.
* gradients of x and of every parameter: float32 within 5e-4 absolute and
  relative, the JAX suite's own bound for this backward
  (``tests/test_fused_block.py``) [1e-7 of max|JAX|]; bf16 within 2e-2 of
  the gradient's largest magnitude [6.5e-3]: every product operand is
  rounded to bf16 on both sides, a few ulps apart.
* the hand backward against autograd of the inference block in float32:
  2e-5 of max|autograd| [6.3e-7]: the two forwards differ only in where
  1/Σe multiplies, one float32 rounding, and the sums run in other
  orders.
* the tiny-v3 trainer: losses within 1e-5 relative and the parameters'
  changes within the bounds of ``test_torch_train.py``'s unfused trainer.
"""

import dataclasses
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.models.s2former import build_model
from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu.train import loop as jloop
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from deepmerge_tpu_torch.infer.extract import FeatureExtractor
from deepmerge_tpu_torch.infer.merge import MergeEngine, merge_scene
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import S2Former, training_model
from deepmerge_tpu_torch.ops.kernels import fused_block as tfb
from deepmerge_tpu_torch.train import loop as tloop
from tests.test_torch_train import (  # noqa: F401 (fixtures)
    DATA,
    DELTA_RMS_TOL,
    DELTA_TOL,
    LOSS_TOL,
    TINY,
    TRAIN,
    _np,
    _samplers,
    flax_params,
    scenes,
)

C, HEADS, HIDDEN, B = 64, 4, 256, 5
DENSE = (2, 5, 9, 11)  # dense kernels of the 13-tuple: (in, out) in JAX
F32_GRAD_TOL = 5e-4
BF16_GRAD_TOL = 2e-2


def _params(rs, n, dtype=np.float32):
    """One block's 13-tuple in the JAX layout, LayerNorm and bias in f32,
    the rest in ``dtype``."""
    r = lambda *shape, s=0.05: (rs.standard_normal(shape) * s).astype(
        np.float32)
    p = (1.0 + r(C), r(C), r(C, 3 * C), r(3 * C), r(HEADS, n, n, s=0.5),
         r(C, C), r(C), 1.0 + r(C), r(C), r(C, HIDDEN), r(HIDDEN),
         r(HIDDEN, C), r(C))
    return tuple(a if i in (0, 1, 4, 7, 8) else a.astype(dtype)
                 for i, a in enumerate(p))


def _port(p):
    """JAX layout → port layout (dense kernels (out, in)), same dtypes."""
    out = []
    for i, a in enumerate(p):
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, np.float32).T if i in DENSE
            else np.asarray(a, np.float32)))
        out.append(t.to(torch.bfloat16) if a.dtype != np.float32 else t)
    return tuple(out)


def _x(rs, n, dtype):
    x = rs.standard_normal((B, n, C)).astype(dtype)
    xt = torch.from_numpy(np.asarray(x, np.float32))
    return x, xt.to(torch.bfloat16) if dtype != np.float32 else xt


def _rel(got, want):
    got, want = _np_f32(got), _np_f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


DTYPES = [pytest.param(np.float32, id="f32"),
          pytest.param(jnp.bfloat16, id="bf16")]


# ------------------------------------------------------------- forward


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [12, 48, 49])
def test_block_train_ref_matches_jax(n, dtype):
    """``block_train_ref`` against ``_fused_block_train_forward`` in
    interpret mode: the output and the four saved residuals (the JAX
    probabilities (B, N, H·N) read as (B, H, N, N))."""
    rs = np.random.default_rng(n)
    p = _params(rs, n, dtype)
    x, xt = _x(rs, n, dtype)
    fwd = jax.jit(lambda x, p: jfb._fused_block_train_forward(
        x, p, HEADS, False, 2, True))
    out, (qkv, probs, gin, r) = fwd(jnp.asarray(x),
                                    tuple(jnp.asarray(a) for a in p))
    probs = _np_f32(probs).reshape(B, n, HEADS, n).transpose(0, 2, 1, 3)
    got_out, got = tfb.block_train_ref(xt, _port(p), HEADS)
    tol = 2e-6 if dtype == np.float32 else 1e-2
    for name, g, w in zip(("out", "qkv", "probs", "gin", "r"),
                          (got_out, *got), (out, qkv, probs, gin, r)):
        assert g.dtype == xt.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))


# ----------------------------------------------------------- gradients


def _jax_grads(x, p, chain=False):
    fn = jfb.fused_block_chain if chain else jfb.fused_block

    def loss(x, p):
        out = fn(x, p, heads=HEADS, block_b=2, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(x, p)


def _port_grads(xt, plist, chain=False):
    xt = xt.clone().requires_grad_(True)
    plist = [[t.clone().requires_grad_(True) for t in p] for p in plist]
    if chain:
        out = tfb.fused_block_chain(xt, plist, HEADS)
    else:
        out = tfb.fused_block(xt, plist[0], HEADS)
    (out.float() ** 2).sum().backward()
    return xt.grad, [[t.grad for t in p] for p in plist]


def _assert_grads_close(got, want, tol_of):
    gx, gps = got
    wx, wps = want
    tol_of("x", gx, wx)
    for b, (gp, wp) in enumerate(zip(gps, wps)):
        for i, (g, w) in enumerate(zip(gp, wp)):
            w = _np_f32(w)
            tol_of(f"block {b} parameter {i}", g, w.T if i in DENSE else w)


def _f32_close(name, g, w):
    np.testing.assert_allclose(_np_f32(g), _np_f32(w), rtol=F32_GRAD_TOL,
                               atol=F32_GRAD_TOL, err_msg=name)


def _bf16_close(name, g, w):
    assert _rel(g, w) <= BF16_GRAD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [12, 49])
def test_block_gradients_match_jax(n, dtype):
    """Gradients of x and of every parameter through the differentiable
    ``fused_block`` (the training forward and ``block_train_bwd``) against
    ``jax.grad`` of the JAX ``fused_block`` (its saved-activation VJP), on
    the loss Σ out²; each parameter's gradient comes in its own dtype."""
    rs = np.random.default_rng(100 + n)
    p = _params(rs, n, dtype)
    x, xt = _x(rs, n, dtype)
    wx, wp = _jax_grads(jnp.asarray(x), tuple(jnp.asarray(a) for a in p))
    gx, (gp,) = _port_grads(xt, [_port(p)])
    assert gx.dtype == xt.dtype
    assert [g.dtype for g in gp] == [t.dtype for t in _port(p)]
    _assert_grads_close((gx, [gp]), (wx, [wp]),
                        _f32_close if dtype == np.float32 else _bf16_close)


@pytest.mark.parametrize("n", [12, 49])
def test_hand_backward_matches_autograd(n):
    """``block_train_bwd`` against torch's autograd of ``block_ref`` in
    float32."""
    rs = np.random.default_rng(200 + n)
    params = _port(_params(rs, n))
    _, x = _x(rs, n, np.float32)
    g = torch.from_numpy(rs.standard_normal((B, n, C)).astype(np.float32))
    out, saved = tfb.block_train_ref(x, params, HEADS)
    dx, dparams = tfb.block_train_bwd(x, params, saved, g, HEADS)
    xs = x.clone().requires_grad_(True)
    ps = [t.clone().requires_grad_(True) for t in params]
    want = torch.autograd.grad(tfb.block_ref(xs, ps, HEADS), [xs, *ps], g)
    for i, (a, b) in enumerate(zip((dx, *dparams), want)):
        assert _rel(a, b) <= 2e-5, (i, _rel(a, b))


@pytest.mark.parametrize("depth", [1, 3])
def test_chain_gradients_match_jax(depth):
    """``fused_block_chain`` differentiates as the JAX package's: a single
    block through the saved-activation VJP, several through the recompute
    of the plain chain (float32, the JAX suite's bound)."""
    rs = np.random.default_rng(300 + depth)
    n = 12
    ps = [_params(rs, n) for _ in range(depth)]
    x, xt = _x(rs, n, np.float32)
    want = _jax_grads(jnp.asarray(x), tuple(tuple(jnp.asarray(a) for a in p)
                                            for p in ps), chain=True)
    got = _port_grads(xt, [_port(p) for p in ps], chain=True)
    _assert_grads_close(got, want, _f32_close)


# ------------------------------------------------- dispatch and the model


def test_dispatch_on_the_cpu():
    """Without grad the block and chain run their inference plain versions;
    with grad the training forward; the w8a8 blocks refuse grad; no launch
    is counted on the CPU."""
    rs = np.random.default_rng(4)
    params = _port(_params(rs, 12))
    _, x = _x(rs, 12, np.float32)
    before = (tfb.fused_block.launches, tfb.fused_block_train.launches,
              tfb.fused_block_chain.launches)
    with torch.no_grad():
        torch.testing.assert_close(tfb.fused_block(x, params, HEADS),
                                   tfb.block_ref(x, params, HEADS),
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            tfb.fused_block_chain(x, [params] * 2, HEADS),
            tfb.chain_ref(x, [params] * 2, HEADS), rtol=0, atol=0)
    xg = x.clone().requires_grad_(True)
    out = tfb.fused_block(xg, params, HEADS)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(),
                               tfb.block_train_ref(x, params, HEADS)[0],
                               rtol=0, atol=0)
    qp = tfb.quantize_block_params(params)
    with pytest.raises(RuntimeError, match="inference-only"):
        tfb.fused_block_q8(xg, qp, HEADS)
    with pytest.raises(RuntimeError, match="inference-only"):
        tfb.fused_block_chain_q8(xg, [qp], HEADS, quant_attn=True)
    assert (tfb.fused_block.launches, tfb.fused_block_train.launches,
            tfb.fused_block_chain.launches) == before


def _train_cfgs(**model_kw):
    """(port Config, JAX Config) of the tiny v3 with ``train.fused_block``
    on."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the experiment's config note
        port = Config(model=ModelConfig(**TINY, **model_kw),
                      data=DataConfig(**DATA),
                      train=TrainConfig(fused_block=True, **TRAIN))
        jcfg = jconfig.Config(model=jconfig.ModelConfig(**TINY, **model_kw),
                              data=jconfig.DataConfig(**DATA),
                              train=jconfig.TrainConfig(fused_block=True,
                                                        **TRAIN))
    return port, jcfg


def test_training_routes_blocks_to_the_training_block(monkeypatch):
    """``training_model`` keeps ``fused_block`` with ``train.fused_block``,
    and a training forward sends every block through the differentiable
    ``fused_block`` (none unfused); with dropout a block leaves the kernel,
    as ``fused_block_eligible`` says in the JAX package."""
    cfg, _ = _train_cfgs()
    mcfg = training_model(cfg)
    assert mcfg.fused_block and not mcfg.fused_stage_chain
    calls = {"block": 0, "unfused": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(s2former, "fused_block",
                        count("block", s2former.fused_block))
    monkeypatch.setattr(s2former.CrossScaleBlock, "unfused",
                        count("unfused", s2former.CrossScaleBlock.unfused))
    model = S2Former(mcfg)
    g = torch.Generator().manual_seed(0)
    patches = [torch.rand((4, s, s, 3), generator=g)
               for s in TINY["input_image_scales"]]
    out = model(patches, torch.rand((4, 19), generator=g), train=True,
                generator=g)
    out.sum().backward()
    assert calls == {"block": sum(TINY["depth"]), "unfused": 0}
    drop = dataclasses.replace(mcfg, drop_ratio=0.1)
    assert not any(b.kernel_eligible for b in S2Former(drop).modules()
                   if isinstance(b, s2former.CrossScaleBlock))


def test_tiny_trainer_with_fused_block_matches_jax(scenes, flax_params):
    """Four scanned float32 steps with ``train.fused_block`` from JAX's
    initial weights on the same epoch arrays: JAX's loss trajectory (its
    blocks through the interpret-mode training kernel and its hand
    backward) and its parameters after, within the unfused trainer's
    bounds."""
    steps = 4
    cfg, jcfg = _train_cfgs()
    ours, theirs = _samplers(scenes)
    spe = len(theirs) // DATA["batch_size"]
    model = build_model(jcfg.model)
    params = jax.tree.map(jnp.asarray, flax_params)
    jstate = jloop.create_train_state(model, jcfg, jax.random.key(0), spe)
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    arrays = theirs.epoch_arrays(11, DATA["batch_size"])
    jepoch = jloop.make_scanned_epoch(model, jcfg, theirs.device_scene)
    jstate, want_losses = jepoch(jstate, *(a[:steps] for a in arrays),
                                 jax.random.key(1))

    start = state_dict_from_flax(flax_params, cfg.model)
    state = tloop.create_train_state(cfg, spe, state_dict=start,
                                     device="cpu")
    epoch_fn = tloop.make_scanned_epoch(cfg, ours.device_scene)
    arrays = ours.epoch_arrays(11, DATA["batch_size"])
    state, losses = epoch_fn(state, *(a[:steps] for a in arrays))
    np.testing.assert_allclose(_np(losses), np.asarray(want_losses),
                               rtol=LOSS_TOL)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params),
                                cfg.model)
    got = state.model.state_dict()
    lr, c = TRAIN["lr"], TINY["embed_dim"]
    for k, _ in state.model.named_parameters():
        d_got, d_want = _np(got[k]) - _np(start[k]), _np(want[k]) - _np(
            start[k])
        keep = np.ones(d_got.shape, bool)
        if k.endswith("attn.qkv.bias"):   # the key third: a true 0
            keep[c : 2 * c] = False
        elif k == "final_features_with_design.bias":   # cancelled by the loss
            keep[:] = False
        for d in (d_got[~keep], d_want[~keep]):
            assert np.abs(d).max(initial=0) <= 3 * lr * steps, k
        d_got, d_want = d_got[keep], d_want[keep]
        scale = np.abs(d_want).max(initial=0)
        if scale == 0:
            assert np.abs(d_got).max(initial=0) == 0, k
            continue
        rms = np.sqrt(((d_got - d_want) ** 2).mean() / (d_want ** 2).mean())
        assert np.abs(d_got - d_want).max() <= DELTA_TOL * scale, k
        assert rms <= DELTA_RMS_TOL, (k, rms)


# -------------------------------------------------- default device


@pytest.mark.parametrize("entry", ["FeatureExtractor", "MergeEngine",
                                   "merge_scene", "create_train_state"])
def test_entry_points_default_to_the_card(entry):
    """Each entry point runs on the card unless the caller asks for the
    CPU: its ``device`` defaults to ``cuda``, and without a card a call
    that leaves it out raises, naming the card, instead of running on the
    CPU."""
    cfg, _ = _train_cfgs()
    fn, call = {
        "FeatureExtractor": (FeatureExtractor,
                             lambda: FeatureExtractor(S2Former(cfg.model))),
        "MergeEngine": (MergeEngine, lambda: MergeEngine()),
        "merge_scene": (merge_scene,
                        lambda: merge_scene(None, np.zeros((1, 4)))),
        "create_train_state": (tloop.create_train_state,
                               lambda: tloop.create_train_state(cfg)),
    }[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
