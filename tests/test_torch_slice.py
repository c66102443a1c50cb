"""The whole segment-and-merge slice of the PyTorch port against the JAX
package on one synthetic scene and the same weights: window gather → crop +
resize → S2Former v3 (two blocks per stage, so stages 1 and 2 take the
chain) → pooling → edge scoring → merge rounds → label map.

float32: embeddings and ``simi`` within 1e-5 (the same float32 operations,
summed in another order), labels, label map and cluster count equal under
an absolute threshold midway across a wide gap of the sorted distances.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.infer.extract import FeatureExtractor as JaxExtractor
from deepmerge_tpu.models.s2former import build_model, init_params
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import DataConfig, ModelConfig
from deepmerge_tpu_torch.geodata.synthetic import generate_scene
from deepmerge_tpu_torch.infer.extract import FeatureExtractor, region_bucket
from deepmerge_tpu_torch.models import s2former
from deepmerge_tpu_torch.models.s2former import S2Former

TINY = dict(
    variant="v3", input_image_scales=(16, 32, 64), cube=8, embed_dim=64,
    depth=(2, 2, 2), num_heads=4, out_dim=32, dtype="float32",
)
TINY_V3 = ModelConfig(**TINY)
DCFG = DataConfig(patch_sizes=(16, 32, 64), max_window=128)
# each package gets its own config, scene and data config, built from the
# same arguments (the synthetic scene is numpy-seeded: equal arrays)
J_DCFG = jconfig.DataConfig(patch_sizes=(16, 32, 64), max_window=128)
SCENE = dict(h=128, w=128, n_regions=24, n_objects=4, points_per_region=2,
             seed=3)
BATCH = 16  # 48 points → three chunks


def _jax_cfg(mcfg):
    """The JAX package's ModelConfig with the fields of the port's."""
    return jconfig.ModelConfig(**dataclasses.asdict(mcfg))


@pytest.fixture(scope="module")
def scene_and_edges():
    scene = generate_scene(**SCENE)
    edges = scene.rag.edges.astype(np.int32)
    pad = (-len(edges)) % 64
    valid = np.arange(len(edges) + pad) < len(edges)
    edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    return (scene, jsynthetic.generate_scene(**SCENE)), edges, valid


@pytest.fixture(scope="module")
def flax_params():
    variables = init_params(build_model(_jax_cfg(TINY_V3)), jax.random.key(0))
    return jax.tree.map(np.asarray, variables["params"])


def _extractors(mcfg, params):
    jx = JaxExtractor(build_model(_jax_cfg(mcfg)), params, batch_size=BATCH)
    model = S2Former(mcfg)
    model.load_state_dict(state_dict_from_flax(params, mcfg), strict=True)
    return jx, FeatureExtractor(model, batch_size=BATCH, device="cpu")


def test_slice_f32_matches_jax(scene_and_edges, flax_params):
    (scene, jscene), edges, valid = scene_and_edges
    jx, tx = _extractors(TINY_V3, flax_params)
    r = scene.regions.num_regions

    want_emb = np.asarray(jx.extract_scene_device(jscene, J_DCFG))
    got_emb = tx.extract_scene_device(scene, DCFG).numpy()
    assert got_emb.shape == (scene.regions.num_points, TINY_V3.out_dim)
    np.testing.assert_allclose(got_emb, want_emb, rtol=1e-5, atol=1e-5)

    # absolute threshold midway across the widest gap in the middle half of
    # the sorted valid distances: merges happen, no edge on the knife edge
    simi0 = np.asarray(jx.segment_scene_device(
        jscene, J_DCFG, edges, valid, num_regions=r, max_rounds=8)[0])
    s = np.sort(simi0[valid])
    lo, hi = len(s) // 4, 3 * len(s) // 4
    i = lo + int(np.argmax(np.diff(s[lo:hi])))
    thr = float((s[i] + s[i + 1]) / 2)

    kw = dict(num_regions=r, max_rounds=8, region_map=scene.labels,
              threshold=thr)
    want = [np.asarray(a) for a in
            jx.segment_scene_device(jscene, J_DCFG, edges, valid, **kw)]
    got = [a.numpy() for a in
           tx.segment_scene_device(scene, DCFG, edges, valid, **kw)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[1].shape == (region_bucket(r),)
    for name, g, w in zip(("labels", "rounds", "label map", "n_clusters"),
                          got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert 1 <= int(got[4]) < r and int(got[2]) >= 1


def test_slice_bf16_close_to_jax(scene_and_edges, flax_params):
    """bf16 on both sides. Tolerance 0.02 relative to the largest embedding
    magnitude, about five bf16 ulps there: bf16 keeps 8 significant bits,
    and the two sides round at the same points but sum in other orders, so
    a one-ulp difference in an early activation can flip later roundings
    through the six blocks and the head (measured: 0.0045, one ulp)."""
    (scene, jscene), _, _ = scene_and_edges
    mcfg = dataclasses.replace(TINY_V3, dtype="bfloat16")
    jx, tx = _extractors(mcfg, flax_params)
    want = np.asarray(jx.extract_scene_device(jscene, J_DCFG))
    got = tx.extract_scene_device(scene, DCFG).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= 0.02, err


@pytest.mark.parametrize("depth,blocks,chains", [
    ((2, 2, 2), 2, 2),   # stage 0 block by block, stages 1 and 2 chained
    ((2, 1, 1), 4, 0),   # single-block stages never reach the chain
    ((3, 4, 2), 3, 2),   # the flagship's pattern at small widths
])
def test_stage_dispatch_matches_jax(monkeypatch, depth, blocks, chains):
    """Stage 0 never chains (``chain_stage0`` is off) and a stage chains
    only with more than one block, as ``S2Former._stage`` dispatches in the
    JAX package."""
    calls = {"block": 0, "chain": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(s2former, "fused_block",
                        count("block", s2former.fused_block))
    monkeypatch.setattr(s2former, "fused_block_chain",
                        count("chain", s2former.fused_block_chain))
    mcfg = dataclasses.replace(TINY_V3, depth=depth)
    model = S2Former(mcfg).eval()
    g = torch.Generator().manual_seed(0)
    patches = [torch.rand((2, s, s, 3), generator=g)
               for s in mcfg.input_image_scales]
    with torch.inference_mode():
        out = model(patches, torch.rand((2, 19), generator=g))
    assert out.shape == (2, mcfg.out_dim)
    assert calls == {"block": blocks, "chain": chains}


@pytest.mark.parametrize("change", [
    dict(variant="vit"),
    dict(chain_stage0=True),
])
def test_unported_configs_raise(change):
    """What the port cannot build raises: the vit at scales other than its
    fixed 28/56/112/224 (the JAX package's ``ValueError``, from
    ``build_model`` as from ``S2Former``), and what the port has not ported
    yet names its ROADMAP item."""
    from deepmerge_tpu_torch.models.s2former import build_model

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the experimental-config warning
        mcfg = dataclasses.replace(TINY_V3, **change)
    if mcfg.variant == "vit":
        for build in (build_model, S2Former):
            with pytest.raises(ValueError, match="28,56,112"):
                build(mcfg)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        S2Former(mcfg)
