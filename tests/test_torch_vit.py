"""The ViT family of the PyTorch port (``models/vit.py``,
``compat/vit_import.py``, ``variant="vit"``) against the JAX package's, on
the CPU.

The pipeline backbone's weights go from the JAX package's init (plus
seeded noise, so that every bias and LayerNorm parameter is nonzero and not
one) through numpy into the port (``state_dict_from_flax``). The modules
alone draw theirs in the port from a numpy seed and reach flax through the
JAX package's own ``map_vit_key`` (which spares the slow eager flax init),
and ``vit_state_dict_from_flax`` must give them back. Inputs come from a
numpy seed. Tolerances, relative to max|JAX|: float32 1e-4 (the
products sum in other orders; measured ≤ 3e-7), bf16 2e-2 (one bf16 rounding
placed differently carries through a block; measured ≤ 5e-3). The
extract-and-merge run holds the embeddings at 1e-4 and the merged labels
equal; the train step's loss at 1e-4 relative (float32).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from deepmerge_tpu import config as jconfig
from deepmerge_tpu.compat import vit_import as jvi
from deepmerge_tpu.geodata import synthetic as jsynthetic
from deepmerge_tpu.models import s2former as js2
from deepmerge_tpu.models import vit as jvit
from deepmerge_tpu_torch.compat import vit_import as tvi
from deepmerge_tpu_torch.compat.weights import state_dict_from_flax
from deepmerge_tpu_torch.config import Config, DataConfig, ModelConfig
from deepmerge_tpu_torch.geodata.synthetic import generate_scene
from deepmerge_tpu_torch.infer.extract import FeatureExtractor
from deepmerge_tpu_torch.models import vit as tvit
from deepmerge_tpu_torch.models.s2former import build_model
from tests.torch_threads import one_torch_thread  # noqa: F401

W = dict(embed_dim=32, depth=2, num_heads=4)
SIZES = (28, 56, 112, 224)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
VIT_CFG = dict(variant="vit", input_image_scales=SIZES, embed_dim=32,
               depth=(2,), num_heads=4, out_dim=16, dtype="float32")
VIT_DATA = dict(patch_sizes=SIZES, factor_slots=4, max_window=256,
                batch_size=4, eval_batch_size=8)


def _noisy(params, seed):
    """The init tree plus N(0, 0.02) noise on every leaf."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + rs.standard_normal(np.shape(a)).astype(np.float32)
                   * 0.02), params)


def _port_tree(module, seed):
    """Randomize ``module``'s parameters from a numpy seed (N(0, 0.05), 1 +
    that for LayerNorm scales) and return the flax tree the JAX package's
    ``map_vit_key`` makes of its ``state_dict``; ``vit_state_dict_from_flax``
    of that tree must give the ``state_dict`` back."""
    rs = np.random.RandomState(seed)
    sd = module.state_dict()
    for k, v in sd.items():
        noise = rs.standard_normal(tuple(v.shape)).astype(np.float32) * 0.05
        is_scale = k.endswith("weight") and v.dim() == 1
        v.copy_(torch.from_numpy(noise + (1.0 if is_scale else 0.0)))
    tree = {}
    for k, v in sd.items():
        path, arr = jvi.map_vit_key(k, v)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = arr
    back = tvi.vit_state_dict_from_flax(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    return tree


def _inputs(seed, b=2):
    rs = np.random.RandomState(seed)
    patches = tuple(rs.rand(b, s, s, 3).astype(np.float32) for s in SIZES)
    return patches, rs.rand(b, 19).astype(np.float32), \
        rs.rand(b, 4).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _rel(got, want):
    got = got[0] if isinstance(got, tuple) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def _sub(sd, prefix):
    """The entries of ``sd`` under ``prefix``, the prefix cut."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_and_block_against_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.RandomState(1).standard_normal((2, 9, 32)).astype(np.float32)
    holder = torch.nn.Module()
    holder.blocks = torch.nn.ModuleList([tvit.Block(32, 4)])
    params = _port_tree(holder, 1)["block0"]
    block = holder.blocks[0]
    xb = jnp.asarray(x, jdt)
    want = jax.jit(jvit.Attention(32, 4, dtype=jdt).apply)(
        {"params": params["attn"]}, xb)
    assert _rel(block.attn(_t(x, tdt)), want) <= TOL[dtype]
    want = jax.jit(jvit.Block(32, 4, dtype=jdt).apply)({"params": params},
                                                       xb)
    assert _rel(block(_t(x, tdt)), want) <= TOL[dtype]


@pytest.mark.parametrize("rep", [None, 16])
def test_vision_transformer_against_jax(rep):
    kw = dict(img_size=32, patch_size=8, num_classes=5,
              representation_size=rep, **W)
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32)
    tm = tvit.VisionTransformer(**kw)
    params = _port_tree(tm, 2)
    want = jax.jit(jvit.VisionTransformer(**kw).apply)({"params": params}, x)
    assert _rel(tm(_t(x)), want) <= TOL["float32"]


@pytest.mark.parametrize("feature,label", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_scale_embed_transformer_against_jax(feature, label):
    kw = dict(out_dim=16, feature_embed=feature, label_embed=label, **W)
    patches, designed, factors = _inputs(3)
    tm = tvit.ScaleEmbedTransformer(**kw)
    params = _port_tree(tm, 3)
    want = jax.jit(jvit.ScaleEmbedTransformer(**kw).apply)(
        {"params": params}, patches, designed if feature else None, factors)
    got = tm(tuple(map(_t, patches)), _t(designed) if feature else None,
             _t(factors))
    if label:
        for g, w in zip(got, want):  # embedding, logits, class feature
            assert _rel(g, w) <= TOL["float32"]
        assert got[1].shape == (2, 11)
    else:
        assert _rel(got, want) <= TOL["float32"]


@pytest.fixture(scope="module")
def vit_weights():
    """The JAX backbone's init (jitted: the eager flax init takes seconds)
    plus noise, as numpy."""
    jm = js2.build_model(jconfig.ModelConfig(**VIT_CFG))
    patches, designed, _ = _inputs(0)
    init = jax.jit(jm.init, static_argnums=3)
    params = init({"params": jax.random.key(1)}, patches, designed,
                  False)["params"]
    return jm, _noisy(params, 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_against_jax(dtype, vit_weights):
    mkw = dict(VIT_CFG, dtype=dtype)
    jm = js2.build_model(jconfig.ModelConfig(**mkw))
    patches, designed, _ = _inputs(4, b=3)
    params = vit_weights[1]
    mcfg = ModelConfig(**mkw)
    tm = build_model(mcfg)
    assert isinstance(tm, tvit.ScaleEmbedBackbone)
    tm.load_state_dict(state_dict_from_flax(params, mcfg), strict=True)
    want = jax.jit(jm.apply, static_argnums=3)({"params": params}, patches,
                                               designed, False)
    assert _rel(tm(tuple(map(_t, patches)), _t(designed)), want) <= TOL[dtype]


def test_port_state_dict_round_trips_through_jax_loader():
    """The port's names are the reference's: a port ``state_dict`` loads
    into the JAX package's trees through its ``load_torch_vit`` completely
    (nothing missing, nothing skipped) and gives back the same values."""
    for i, tm in enumerate((
            tvit.ScaleEmbedTransformer(out_dim=16, label_embed=True, **W),
            tvit.VisionTransformer(img_size=32, patch_size=8, num_classes=5,
                                   representation_size=16, **W))):
        # the JAX tree of another draw, as a template to load into
        params = _port_tree(tm, 10 + i)
        _port_tree(tm, 20 + i)
        new, report = jvi.load_torch_vit(params, tm.state_dict(),
                                         drop_head=False)
        assert report["missing"] == [] and report["skipped"] == []
        back = tvi.vit_state_dict_from_flax(new)
        for k, v in tm.state_dict().items():
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("has_logits", [True, False])
def test_load_report_equals_jax(has_logits):
    """The same reference-layout ``state_dict`` (with an extra key and a
    head of another class count) partial-loaded both ways: the same keys
    loaded, missing and skipped (the JAX report names flax paths; they are
    mapped back to the ``state_dict``'s keys), and the loaded weights
    equal."""
    kw = dict(img_size=32, patch_size=8, num_classes=5,
              representation_size=16, **W)
    tm = tvit.VisionTransformer(**kw)
    params = _port_tree(tm, 7)
    src = tvit.VisionTransformer(**dict(kw, num_classes=7))
    _port_tree(src, 8)
    sd = dict(src.state_dict())
    sd["dist_token"] = torch.zeros(1, 1, 32)

    to_key = {}
    for k, v in sd.items():
        mapped = jvi.map_vit_key(k, v)
        if mapped is not None:
            to_key[".".join(mapped[0])] = k
    new, jrep = jvi.load_torch_vit(params, sd, has_logits=has_logits)
    trep = tvi.load_torch_vit(tm, sd, has_logits=has_logits)
    assert sorted(trep["loaded"]) == sorted(to_key[p] for p in jrep["loaded"])
    assert sorted(trep["missing"]) == sorted(
        to_key.get(p, p.replace("kernel", "weight"))
        for p in jrep["missing"])
    jskip = sorted(s if s in sd else to_key[s.split(" ")[0]]
                   for s in jrep["skipped"])
    assert sorted(s.split(" ")[0] for s in trep["skipped"]) == jskip
    back = tvi.vit_state_dict_from_flax(new)
    for k in trep["loaded"]:
        assert torch.equal(back[k], tm.state_dict()[k]), k


def test_factories_widths_equal_jax():
    """All six factories, built on the meta device (no weights)."""
    names = ("vit_base_patch16_224_in21k", "vit_base_patch32_224_in21k",
             "vit_large_patch16_224_in21k", "vit_large_patch32_224_in21k",
             "vit_huge_patch14_224_in21k")
    with torch.device("meta"):
        for name in names:
            for has_logits in (True, False):
                j = getattr(jvit, name)(num_classes=9, has_logits=has_logits)
                t = getattr(tvit, name)(num_classes=9, has_logits=has_logits)
                assert t.patch_embed.patch == j.patch_size
                assert len(t.blocks) == j.depth
                assert t.blocks[0].attn.num_heads == j.num_heads
                assert t.pos_embed.shape == (
                    1, (j.img_size // j.patch_size) ** 2 + 1, j.embed_dim)
                assert t.head.out_features == j.num_classes
                assert (t.pre_logits.fc.out_features if has_logits
                        else None) == j.representation_size
        j = jvit.vit_base_patch_scales_224_in21k(num_classes=21843)
        t = tvit.vit_base_patch_scales_224_in21k(num_classes=21843,
                                                 is_label_embed=True)
        assert (len(t.blocks), t.blocks[0].attn.num_heads,
                t.cls_token.shape[-1]) == (j.depth, j.num_heads, j.embed_dim)
        assert t.class_logits.out_features == j.num_classes == 11


def test_build_model_errors():
    with pytest.raises(ValueError, match="28,56,112"):
        build_model(ModelConfig(variant="vit",
                                input_image_scales=(32, 64, 128)))
    with pytest.raises(ValueError, match="unknown model.variant"):
        build_model(ModelConfig(variant="v9"))


def test_quantize_is_a_no_op_for_vit():
    with pytest.warns(UserWarning, match="quantize is a no-op"):
        mcfg = ModelConfig(**dict(VIT_CFG, quantize="w8a8"))
    model = build_model(mcfg)
    assert isinstance(model, tvit.ScaleEmbedBackbone)
    assert not FeatureExtractor(model, device="cpu").needs_calibration


def test_extract_and_merge_against_jax(vit_weights):
    """``process_scene`` of both packages on a 96² scene, the same
    weights: embeddings to 1e-4 of their largest entry, equal merges."""
    from deepmerge_tpu.infer.driver import process_scene as jprocess
    from deepmerge_tpu_torch.infer.driver import process_scene

    jm, params = vit_weights
    scene_kw = dict(h=96, w=96, n_regions=10, n_objects=3, seed=31)
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**VIT_CFG),
                          data=jconfig.DataConfig(**VIT_DATA))
    cfg = Config(model=ModelConfig(**VIT_CFG), data=DataConfig(**VIT_DATA))
    quiet = lambda *_: None
    jemb, jsimi, jres = jprocess(jcfg, jsynthetic.generate_scene(**scene_kw),
                                 jm, params, None, log_fn=quiet)
    model = build_model(cfg.model)
    model.load_state_dict(state_dict_from_flax(params, cfg.model))
    emb, simi, res = process_scene(cfg, generate_scene(**scene_kw), model,
                                   log_fn=quiet, device="cpu")
    assert emb.shape == jemb.shape == (jemb.shape[0], 16)
    assert np.abs(emb - jemb).max() <= 1e-4 * np.abs(jemb).max()
    np.testing.assert_allclose(simi, jsimi, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(res.region_to_cluster,
                                  jres.region_to_cluster)


def test_train_step_against_jax(vit_weights):
    """One Siamese contrastive step on the same weights and batch (the
    samplers draw the same points): the step-0 loss within 1e-4
    relative."""
    from deepmerge_tpu.train import loop as jloop
    from deepmerge_tpu.train import sampler as jsampler
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs
    from deepmerge_tpu_torch.train import loop as tloop
    from deepmerge_tpu_torch.train import sampler as tsampler

    jm, params = vit_weights
    scene_kw = dict(h=96, w=96, n_regions=10, n_objects=3, seed=32)
    jcfg = jconfig.Config(model=jconfig.ModelConfig(**VIT_CFG),
                          data=jconfig.DataConfig(**VIT_DATA))
    cfg = Config(model=ModelConfig(**VIT_CFG), data=DataConfig(**VIT_DATA))
    jscene = jsynthetic.generate_scene(**scene_kw)
    scene = generate_scene(**scene_kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # window-cap clamping note
        jbatch = next(iter(jsampler.PairSampler(
            jscene, *jsynthetic.make_training_pairs(jscene),
            jcfg.data).epoch_batches(epoch_seed=0, batch_size=4)))
        batch = next(iter(tsampler.PairSampler(
            scene, *make_training_pairs(scene), cfg.data).epoch_batches(
                epoch_seed=0, batch_size=4)))
    # create_train_state's state on these parameters (its eager init of
    # the flax model takes seconds)
    params = jax.tree.map(jnp.asarray, params)
    tx = optax.adam(jloop.lr_schedule(jcfg, 1))
    jstate = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), batch_stats=FrozenDict(), tx=tx,
        apply_fn=jm.apply)
    _, jmetrics = jloop.make_train_step(jm, jcfg)(jstate, jbatch,
                                                  jax.random.key(1))
    state = tloop.create_train_state(
        cfg, 1, state_dict=state_dict_from_flax(params, cfg.model),
        device="cpu")
    _, metrics = tloop.make_train_step(cfg)(state, batch)
    want, got = float(jmetrics["loss"]), float(metrics["loss"])
    assert np.isfinite(got) and abs(got - want) <= 1e-4 * abs(want)
