"""Every S2Former variant of the PyTorch port against the JAX package, on
the CPU: the same parameters (JAX's ``init_params``, carried over by
``state_dict_from_flax``) and the same seeded inputs through both models,
at the sizes of ``tests/test_model.py``'s ``VARIANT_CFGS``, on each block
path: the default (the block kernels' plain versions here, the Pallas
kernels in interpret mode there), ``exact_gelu=True`` and
``fused_block=False`` (both unfused: the attention-only kernel K7's plain
version here, ``fused_attention_qkv`` in interpret mode there).

Tolerances, relative to max|JAX| (measured in brackets):
* float32: 1e-5 — the same float32 operations summed in other orders
  [≤ 3e-7].
* bfloat16: 2e-2 — both sides round to bf16 (one ulp 2^-8 relative) at
  the same points, but a sum taken in another order can round the other
  way and carry through the blocks [≤ 3.7e-3].
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.compat.torch_export import flax_to_torch_state_dict
from deepmerge_tpu.config import ModelConfig as JaxModelConfig
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu.models.s2former import (
    rel_pos_index_extra_token as jax_extra_index,
)
from deepmerge_tpu_torch.compat.weights import (
    init_state_dict,
    state_dict_from_flax,
)
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import (
    S2Former,
    rel_pos_index_extra_token,
)

# tests/test_model.py's VARIANT_CFGS, as keyword arguments
VARIANTS = {
    "v1": dict(variant="v1", input_image_scales=(14, 28, 56, 112), cube=7,
               embed_dim=32, depth=(2,), num_heads=4, out_dim=16),
    "v2": dict(variant="v2", input_image_scales=(16, 32), cube=8,
               embed_dim=32, depth=(2,), num_heads=4, out_dim=16),
    "v3": dict(variant="v3", input_image_scales=(16, 32, 64), cube=8,
               embed_dim=32, depth=(2, 1, 1), num_heads=4, out_dim=16),
    "v4": dict(variant="v4", input_image_scales=(16, 32, 64), cube=8,
               embed_dim=32, depth=(1, 1, 1), num_heads=4, out_dim=16),
    "v5": dict(variant="v5", input_image_scales=(16, 32, 64), cube=8,
               embed_dim=32, depth=(1, 1, 1), num_heads=4, out_dim=16),
    "v6": dict(variant="v6", embed_dim=32, out_dim=16),
}
PATHS = {"default": {}, "exact_gelu": dict(exact_gelu=True),
         "unfused": dict(fused_block=False)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(variant, **change):
    kw = dict(VARIANTS[variant], **change)
    return ModelConfig(**kw), JaxModelConfig(**kw)


def _jax_variables(jcfg):
    variables = init_params(build_model(jcfg), jax.random.key(0))
    return (jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables.get("batch_stats", {})))


def _inputs(mcfg, seed=0, b=3):
    rs = np.random.default_rng(seed)
    patches = [rs.random((b, s, s, mcfg.in_channels), dtype=np.float32)
               for s in mcfg.input_image_scales]
    designed = rs.standard_normal((b, mcfg.designed_feature_dim)).astype(
        np.float32)
    return patches, designed


def _port_model(mcfg, params, batch_stats):
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(params, mcfg, batch_stats),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax_float32(variant, path):
    mcfg, jcfg = _configs(variant, dtype="float32", **PATHS[path])
    params, bs = _jax_variables(jcfg)
    patches, designed = _inputs(mcfg)
    want = np.asarray(build_model(jcfg).apply(
        {"params": params, "batch_stats": bs},
        tuple(jnp.asarray(p) for p in patches), jnp.asarray(designed),
        False))
    with torch.inference_mode():
        got = _port_model(mcfg, params, bs)(
            [torch.from_numpy(p) for p in patches],
            torch.from_numpy(designed)).numpy()
    assert got.shape == want.shape == (3, mcfg.out_dim)
    assert np.abs(got - want).max() <= TOL["float32"] * np.abs(want).max()


@pytest.mark.parametrize("path", ["default", "exact_gelu"])
@pytest.mark.parametrize("variant", ["v1", "v4", "v5"])
def test_forward_matches_jax_bfloat16(variant, path):
    """bf16 compute from float32 parameters, as both packages serve."""
    mcfg, jcfg = _configs(variant, dtype="bfloat16", **PATHS[path])
    params, bs = _jax_variables(jcfg)
    patches, designed = _inputs(mcfg, seed=1)
    want = np.asarray(build_model(jcfg).apply(
        {"params": params, "batch_stats": bs},
        tuple(jnp.asarray(p) for p in patches), jnp.asarray(designed),
        False).astype(jnp.float32))
    with torch.inference_mode():
        got = _port_model(mcfg, params, bs)(
            [torch.from_numpy(p) for p in patches],
            torch.from_numpy(designed))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= TOL["bfloat16"] * np.abs(want).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_dict_equals_the_exporter_and_loads_strict(variant):
    """``state_dict_from_flax`` equals the JAX package's
    ``flax_to_torch_state_dict`` key for key and value for value (BatchNorm
    statistics included), and the exporter's output loads strictly."""
    mcfg, jcfg = _configs(variant, dtype="float32")
    params, bs = _jax_variables(jcfg)
    # statistics other than the initial ones, so that a swap would show
    bs = jax.tree.map(lambda a: a + np.float32(0.25), bs)
    want = flax_to_torch_state_dict({"params": params, "batch_stats": bs},
                                    jcfg)
    ours = state_dict_from_flax(params, mcfg, bs)
    assert sorted(ours) == sorted(want)
    for k, v in want.items():
        assert tuple(ours[k].shape) == np.shape(v), k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    S2Former(mcfg).load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in want.items()},
        strict=True)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_state_dict_loads_strict(variant):
    mcfg, _ = _configs(variant, dtype="float32")
    sd = init_state_dict(mcfg, seed=1)
    S2Former(mcfg).load_state_dict(sd, strict=True)
    for k, t in sd.items():
        if k.endswith(("norm.weight", "norm1.weight", "norm2.weight",
                       "aux.1.weight", "running_var")):
            assert float(t.min()) == float(t.max()) == 1.0, k
        elif k.endswith(("running_mean", ".bias")):
            assert float(t.abs().max()) == 0.0, k


def test_init_state_dict_draws_by_name():
    """A tensor's random values follow (seed, name) alone: v4 adds the aux
    heads to v3 and leaves every shared weight as v3 draws it; another
    seed draws others."""
    v3, _ = _configs("v3", dtype="float32")
    v4 = dataclasses.replace(v3, variant="v4")
    a, b = init_state_dict(v3, seed=2), init_state_dict(v4, seed=2)
    assert set(a) < set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    other = init_state_dict(v3, seed=3)
    w = "blocks0.0.attn.qkv.weight"
    assert not torch.equal(a[w], other[w])


@pytest.mark.parametrize("cube",[(3, 8, 8), (3, 4, 4), (3, 2, 2)])
def test_extra_token_index_matches_jax(cube):
    idx, table = rel_pos_index_extra_token(cube)
    want, want_table = jax_extra_index(cube)
    assert idx.dtype == np.int32 and table == want_table
    np.testing.assert_array_equal(idx, want)
    assert idx.max() < table and idx[-1, -1] == idx[0, 0]


def test_v5_attention_bias_is_extended():
    """v5's blocks attend over N + 1 tokens with the extended table."""
    mcfg, _ = _configs("v5", dtype="float32")
    model = S2Former(mcfg)
    c, g = mcfg.n_scales, mcfg.cube
    for blocks, grid in ((model.blocks0, g), (model.blocks1, g // 2),
                         (model.blocks2, g // 4)):
        n = c * grid * grid + 1
        attn = blocks[0].attn
        assert tuple(attn.bias().shape) == (mcfg.num_heads, n, n)
        assert attn.relative_position_bias_table.shape[0] == \
            (2 * c - 1) * (2 * grid - 1) ** 2 + 2 * (n - 1)


@pytest.mark.parametrize("change", [
    dict(variant="v1", input_image_scales=(16, 32, 64), cube=8,
         depth=(2,)),
    dict(variant="v7"),
])
def test_build_refuses_what_jax_refuses(change):
    """v1 takes four scales; an unknown variant is refused."""
    mcfg = dataclasses.replace(ModelConfig(), **change)
    with pytest.raises(ValueError):
        S2Former(mcfg)


def test_quantize_on_an_unfused_block_serves_bf16(monkeypatch):
    """``quantize`` with the block kernels off is a no-op, as in the JAX
    package (its config warns): the blocks run unfused through K7."""
    calls, k7 = [], s2former.fused_attention_qkv
    monkeypatch.setattr(s2former, "fused_attention_qkv",
                        lambda *a: calls.append(1) or k7(*a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mcfg, _ = _configs("v5", dtype="float32", quantize="w8a8",
                           exact_gelu=True)
    model = S2Former(mcfg).eval()
    assert not any(b.quantize for b in model.modules()
                   if isinstance(b, s2former.CrossScaleBlock))
    patches, designed = _inputs(mcfg)
    with torch.inference_mode():
        out = model([torch.from_numpy(p) for p in patches],
                    torch.from_numpy(designed))
    assert out.shape == (3, mcfg.out_dim) and len(calls) == 3
