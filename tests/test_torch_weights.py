"""Weights cross from the JAX package to the PyTorch port: the port's
jax-free mapper equals the JAX package's exporter, the port's S2Former loads
the result strictly, and its relative-position index equals the JAX one."""

import zlib

import jax
import numpy as np
import pytest
import torch

from deepmerge_tpu.compat.torch_export import flax_to_torch_state_dict
from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.models.s2former import rel_pos_index as jax_rel_pos_index
from deepmerge_tpu_torch.compat.weights import (
    init_state_dict,
    state_dict_from_flax,
)
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import S2Former, rel_pos_index

# tiny v3 with two blocks in every stage, so stages 1 and 2 reach the chain
TINY_V3 = dict(
    variant="v3", input_image_scales=(16, 32, 64), cube=8, embed_dim=64,
    depth=(2, 2, 2), num_heads=4, out_dim=32, dtype="float32",
)


@pytest.fixture(scope="module", params=[True, False],
                ids=["designed", "no-designed"])
def tiny(request):
    """The same tiny v3 as each package's own config, and JAX's initial
    parameters."""
    kw = dict(TINY_V3, use_designed_features=request.param)
    jcfg = JaxModelConfig(**kw)
    variables = init_params(build_model(jcfg), jax.random.key(0))
    params = jax.tree.map(np.asarray, variables["params"])
    return ModelConfig(**kw), jcfg, params


def test_state_dict_from_flax_equals_exporter(tiny):
    mcfg, jcfg, params = tiny
    ours = state_dict_from_flax(params, mcfg)
    want = flax_to_torch_state_dict({"params": params}, jcfg)
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert tuple(ours[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_port_model_loads_strict(tiny):
    mcfg, _, params = tiny
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(params, mcfg), strict=True)


def test_init_state_dict_loads_strict_and_is_seeded():
    mcfg = ModelConfig(**TINY_V3)
    a, b = init_state_dict(mcfg, seed=0), init_state_dict(mcfg, seed=0)
    S2Former(mcfg).load_state_dict(a, strict=True)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["blocks0.0.attn.qkv.weight"]
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.025
    assert float(a["final_features.weight"].abs().max()) == 0.0  # never called
    assert float(a["norm.weight"].min()) == 1.0


@pytest.mark.parametrize("seed", [0, 3])
def test_init_state_dict_draws_the_truncated_normal(seed):
    """Every random tensor of ``init_state_dict`` is, bit for bit, the
    truncated normal drawn from its (seed, name) generator by redrawing
    every entry past ±2 std over the whole tensor, pass after pass, in
    index order, then scaled by 0.02."""
    mcfg = ModelConfig(**TINY_V3)
    sd = init_state_dict(mcfg, seed=seed)
    drawn = 0
    for key, t in sd.items():
        if not t.is_floating_point() or float(t.std()) == 0.0:
            continue  # zeros, ones and the position index
        rng = np.random.default_rng([seed, zlib.crc32(key.encode())])
        w = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        while (bad := np.abs(w) > 2.0).any():
            w[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        assert torch.equal(t, torch.from_numpy(w * np.float32(0.02))), key
        drawn += 1
    assert drawn > 10


@pytest.mark.parametrize("cube", [(3, 8, 8), (3, 4, 4), (3, 2, 2)])
def test_rel_pos_index_matches_jax(cube):
    ours = rel_pos_index(cube)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, jax_rel_pos_index(cube))


@pytest.mark.parametrize("heads", [3, 4])
def test_wide_heads_load_strict(heads):
    """Flax parameters at the flagship's embed 768 with 3 or 4 heads (of
    256 and 192, wider than 128) cross to the port as the JAX exporter
    maps them and load strictly; each block's bias table keeps one column
    a head, equal to flax's ``rel_pos_bias_table``."""
    kw = dict(TINY_V3, embed_dim=768, depth=(1, 1, 1), num_heads=heads)
    mcfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    params = jax.tree.map(np.asarray, init_params(
        build_model(jcfg), jax.random.key(1))["params"])
    ours = state_dict_from_flax(params, mcfg)
    want = flax_to_torch_state_dict({"params": params}, jcfg)
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    S2Former(mcfg).load_state_dict(ours, strict=True)
    tables = [k for k in ours if k.endswith("relative_position_bias_table")]
    assert len(tables) == 3
    for k in tables:
        stage, block = k.split(".")[:2]  # blocksS.J -> flax's blocksS_J
        flax = params[f"{stage}_{block}"]["attn"]["rel_pos_bias_table"]
        assert tuple(ours[k].shape) == flax.shape and flax.shape[1] == heads
        for h in range(heads):
            np.testing.assert_array_equal(ours[k][:, h].numpy(), flax[:, h])
