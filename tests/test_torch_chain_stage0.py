"""``model.chain_stage0``: stage 0 as one chain launch, as the JAX package
chains it (``fused_stage_chain and chain_stage0``), on the CPU.

The tiny v3 (scales 16/32/64, cube 8: N 192 at stage 0; 2 heads of 32)
with ``chain_stage0=True`` against the JAX package's forward of the same
configuration (its chain kernel in interpret mode) on
``state_dict_from_flax`` weights, in float32: bf16 blocks' path (the plain
chain), w8a8 and w8a8+attn. Tolerances, relative to max|JAX|: 1e-5 for the
unquantized path (``tests/test_torch_variants.py``), 2e-3 for w8a8 and
w8a8+attn (the w8a8 slice's bound, ``tests/test_torch_serving.py``). Then
``w8a8-static``: calibration runs block by block and the served stage 0
chains with the calibrated 18-tuples, equal bit for bit to the unchained
model; and the CLI override reaches the path.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import Config, ModelConfig, apply_overrides
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import S2Former

TINY = dict(variant="v3", input_image_scales=(16, 32, 64), cube=8,
            embed_dim=64, depth=(2, 2, 1), num_heads=2, out_dim=16,
            dtype="float32", chain_stage0=True)
TOL = {"": 1e-5, "w8a8": 2e-3, "w8a8+attn": 2e-3}
CHAINS = {"": "fused_block_chain", "w8a8": "fused_block_chain_q8",
          "w8a8+attn": "fused_block_chain_q8"}


def _configs(**change):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the experimental-config warning
        kw = dict(TINY, **change)
        return ModelConfig(**kw), JaxModelConfig(**kw)


@pytest.fixture(scope="module")
def variables():
    """JAX's initial variables of the tiny model, as numpy (the tree is the
    same on every block path, so it is built off the kernels)."""
    _, jcfg = _configs(fused_block=False, fused_attention=False,
                       chain_stage0=False)
    return jax.tree.map(np.asarray, jax.jit(
        lambda key: init_params(build_model(jcfg), key))(jax.random.key(0)))


def _inputs(b=3):
    rs = np.random.default_rng(11)
    patches = [rs.random((b, s, s, 3), dtype=np.float32)
               for s in TINY["input_image_scales"]]
    return patches, rs.standard_normal((b, 19)).astype(np.float32)


def _count(monkeypatch, names):
    calls = {k: 0 for k in names}

    def wrap(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    for k in names:
        monkeypatch.setattr(s2former, k, wrap(k, getattr(s2former, k)))
    return calls


def _port(mcfg, variables):
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(variables["params"], mcfg),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("quantize", ["", "w8a8", "w8a8+attn"],
                         ids=["bf16-path", "w8a8", "w8a8-attn"])
def test_chain_stage0_matches_jax(monkeypatch, variables, quantize):
    mcfg, jcfg = _configs(quantize=quantize)
    patches, designed = _inputs()
    want = np.asarray(jax.jit(build_model(jcfg).apply, static_argnums=3)(
        variables, tuple(jnp.asarray(p) for p in patches),
        jnp.asarray(designed), False))
    names = ("fused_block", "fused_block_chain", "fused_block_q8",
             "fused_block_chain_q8")
    calls = _count(monkeypatch, names)
    with torch.inference_mode():
        got = _port(mcfg, variables)([torch.from_numpy(p) for p in patches],
                                     torch.from_numpy(designed)).numpy()
    # stage 0 and stage 1 chain; stage 2's single block does not
    block = "fused_block_q8" if quantize else "fused_block"
    assert calls == {k: (2 if k == CHAINS[quantize] else
                         1 if k == block else 0) for k in names}
    assert got.shape == want.shape == (3, 16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= TOL[quantize], rel


def test_static_calibrates_block_by_block_then_chains(monkeypatch,
                                                       variables):
    """``w8a8-static`` with ``chain_stage0``: calibration runs every block
    through ``block_act_amax`` (no chain), serving chains stage 0 with the
    calibrated 18-tuples, and the result equals the unchained model's bit
    for bit (the plain chain is the plain blocks back to back)."""
    patches, designed = _inputs()
    patches = [torch.from_numpy(p) for p in patches]
    designed = torch.from_numpy(designed)
    widths, chain = [], s2former.fused_block_chain_q8
    monkeypatch.setattr(
        s2former, "fused_block_chain_q8",
        lambda x, qps, **kw: widths.append([len(q) for q in qps])
        or chain(x, qps, **kw))
    outs = {}
    for stage0 in (False, True):
        mcfg, _ = _configs(quantize="w8a8-static", chain_stage0=stage0)
        model = _port(mcfg, variables)
        widths.clear()
        model.calibrate(patches, designed)
        assert widths == []
        with torch.inference_mode():
            outs[stage0] = model(patches, designed)
        assert widths == [[18, 18]] * (2 if stage0 else 1)
    torch.testing.assert_close(outs[True], outs[False], rtol=0, atol=0)


def test_cli_override_reaches_the_path():
    """``model.chain_stage0=true`` on the command line sets the field, the
    model builds and the training model clears it, as the JAX package's
    does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = apply_overrides(Config(), ["model.chain_stage0=true",
                                         "model.quantize=w8a8"])
        mcfg = dataclasses.replace(cfg.model, **{
            k: v for k, v in TINY.items() if k != "chain_stage0"})
    assert cfg.model.chain_stage0 and cfg.model.quantize == "w8a8"
    assert mcfg.chain_stage0 and isinstance(S2Former(mcfg), S2Former)
    assert not s2former.training_model(
        dataclasses.replace(cfg, model=mcfg)).chain_stage0
