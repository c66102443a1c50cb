"""Weights for the port's backbones: S2Former v1–v6 and the ViT backbone
(``variant="vit"``).

``state_dict_from_flax`` maps the JAX package's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, variables["params"])``)
and, for v4 and v5, its BatchNorm ``batch_stats`` onto the port's
``state_dict`` — the reference layout that
``deepmerge_tpu/compat/torch_export.py`` writes (for vit the reference
``vit_model.py``'s), rewritten without JAX.
``init_state_dict`` makes weights of the same layout from a numpy seed, for
runs with no JAX at hand. ``load_reference_checkpoint`` reads a reference
``.pth``, and ``act_amax_from_flax`` carries the JAX package's calibrated
``w8a8-static`` activation scales across.
"""

from __future__ import annotations

import zlib
from typing import Mapping, Optional

import numpy as np
import torch

from deepmerge_tpu_torch.compat.vit_import import vit_state_dict_from_flax
from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import (
    bias_index,
    build_model,
    check_supported,
)

SINGLE_STAGE = ("v1", "v2")


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _stages(mcfg: ModelConfig):
    """(flax stage index, depth, grid) of each stage of blocks."""
    g = mcfg.cube
    if mcfg.variant in SINGLE_STAGE:
        return [(0, mcfg.depth[0], g)]
    return [(0, mcfg.depth[0], g), (1, mcfg.depth[1], g // 2),
            (2, mcfg.depth[2], g // 4)]


def state_dict_from_flax(params: Mapping, mcfg: ModelConfig,
                         batch_stats: Optional[Mapping] = None
                         ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax parameter tree of any variant.

    Dense kernels (in, out) become Linear weights (out, in); the patch-embed
    kernels become (D, C, p, p) convolution weights; the designed-feature
    dense layers become (D, in, 1) Conv1d weights; the aux heads' HWIO
    convolutions become OIHW, their BatchNorm running mean and variance
    come from ``batch_stats`` (flax's initial zeros and ones without it) and
    ``num_batches_tracked`` is 0; layers the flax tree lacks (constructed
    but never called: an output projection, the class head, v5's aux
    LayerNorm) become zeros, or ones for a LayerNorm scale; every block gets
    its ``relative_position_index`` buffer. For vit, the ViT tree under
    ``"vit"`` through ``vit_state_dict_from_flax``.
    """
    check_supported(mcfg)
    if mcfg.variant == "vit":
        return vit_state_dict_from_flax(params["vit"], mcfg.in_channels)
    sd: dict[str, np.ndarray] = {}
    d, n = mcfg.embed_dim, mcfg.n_scales

    def linear(key, node):
        sd[key + ".weight"] = _f32(node["kernel"]).T
        sd[key + ".bias"] = _f32(node["bias"])

    def zeros_linear(key, out_dim, in_dim):
        sd[key + ".weight"] = np.zeros((out_dim, in_dim), np.float32)
        sd[key + ".bias"] = np.zeros((out_dim,), np.float32)

    def linear_or_zeros(key, out_dim, in_dim):
        if key in params:
            linear(key, params[key])
        else:
            zeros_linear(key, out_dim, in_dim)

    def norm(key, node):
        sd[key + ".weight"] = _f32(node["scale"])
        sd[key + ".bias"] = _f32(node["bias"])

    def conv(key, node):  # flax HWIO -> torch OIHW
        sd[key + ".weight"] = _f32(node["kernel"]).transpose(3, 2, 0, 1)

    if "feature_embed" in params:
        for i in range(3):
            node = params["feature_embed"][f"proj{i}"]
            sd[f"feature_embed.proj{i}.weight"] = _f32(node["kernel"]).T[:, :, None]
            sd[f"feature_embed.proj{i}.bias"] = _f32(node["bias"])
    norm("norm", params["norm"])
    if mcfg.num_classes > 0:
        linear_or_zeros("head", mcfg.num_classes, mcfg.out_dim)
    if mcfg.variant == "v6":
        linear("final_features_with_design",
               params["final_features_with_design"])
        return _tensors(sd)

    for i, s in enumerate(mcfg.input_image_scales):
        p = s // mcfg.cube
        node = params[f"patch_embed{i}"]["proj"]
        k = _f32(node["kernel"]).reshape(p, p, mcfg.in_channels, d)
        key = (f"patch_embed_scale{i}" if mcfg.variant == "v1"
               else f"patch_embed_blocks.{i}")
        sd[key + ".proj.weight"] = k.transpose(3, 2, 0, 1)
        sd[key + ".proj.bias"] = _f32(node["bias"])

    extra = mcfg.variant == "v5"
    single = mcfg.variant in SINGLE_STAGE  # one stage, named ``blocks``
    for stage, depth, g in _stages(mcfg):
        idx, _ = bias_index((n, g, g), extra)
        for k in range(depth):
            f = params[f"blocks{stage}_{k}"]
            t = f"blocks.{k}" if single else f"blocks{stage}.{k}"
            norm(t + ".norm1", f["norm1"])
            norm(t + ".norm2", f["norm2"])
            linear(t + ".attn.qkv", f["attn"]["qkv"])
            linear(t + ".attn.proj", f["attn"]["proj"])
            sd[t + ".attn.relative_position_bias_table"] = _f32(
                f["attn"]["rel_pos_bias_table"])
            sd[t + ".attn.relative_position_index"] = idx.astype(np.int64)
            linear(t + ".mlp.fc1", f["mlp"]["Dense_0"])
            linear(t + ".mlp.fc2", f["mlp"]["Dense_1"])

    linear_or_zeros("final_features", 100, n * d)
    if extra:
        linear("last_block_features", params["last_block_features"])
        linear("final_features_with_design",
               params["final_features_with_design"])
    else:
        linear_or_zeros("final_features_with_design", 100, (n + 1) * d)

    if mcfg.variant in ("v4", "v5"):
        for name in ("aux0", "aux1"):
            f = params[name]
            stats = (batch_stats or {}).get(name, {}).get("bn")
            conv(name + ".aux.0", f["conv1"])
            sd[name + ".aux.1.weight"] = _f32(f["bn"]["scale"])
            sd[name + ".aux.1.bias"] = _f32(f["bn"]["bias"])
            sd[name + ".aux.1.running_mean"] = (
                _f32(stats["mean"]) if stats else np.zeros((d,), np.float32))
            sd[name + ".aux.1.running_var"] = (
                _f32(stats["var"]) if stats else np.ones((d,), np.float32))
            sd[name + ".aux.1.num_batches_tracked"] = np.asarray(0, np.int64)
            conv(name + ".aux.4", f["conv2"])
            sd[name + ".aux.4.bias"] = _f32(f["conv2"]["bias"])
            if "norm" in f:  # v4 applies it
                norm(name + ".norm", f["norm"])
            else:  # v5 constructs a LayerNorm(2D) it never calls
                sd[name + ".norm.weight"] = np.ones((2 * d,), np.float32)
                sd[name + ".norm.bias"] = np.zeros((2 * d,), np.float32)
            linear(name + ".out_features", f["out"])
    return _tensors(sd)


def _tensors(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _called_heads(mcfg: ModelConfig) -> tuple[str, ...]:
    """The output projections the forward calls (the others stay zero)."""
    if mcfg.variant == "v5":
        return ("final_features_with_design", "last_block_features")
    if mcfg.use_designed_features or mcfg.variant == "v6":
        return ("final_features_with_design",)
    return ("final_features",)


def init_state_dict(mcfg: ModelConfig, seed: int = 0
                    ) -> dict[str, torch.Tensor]:
    """Random weights of the port's layout: weight matrices, convolutions,
    bias tables, tokens and position embeddings truncated normal (std 0.02,
    cut at ±2 std), biases zero, LayerNorm and BatchNorm scales one,
    BatchNorm running statistics flax's initial zeros and ones. The
    projections and the head the model never calls stay zero, as in an
    exported checkpoint. Each tensor draws
    from a numpy generator seeded by (``seed``, its name), so its values do
    not depend on the order or the presence of other modules."""
    heads = ("final_features", "final_features_with_design",
             "last_block_features", "head")
    called = _called_heads(mcfg)
    sd = {}
    for key, t in build_model(mcfg).state_dict().items():
        module = key.rsplit(".", 1)[0]
        if key.endswith("relative_position_index"):
            sd[key] = t
        elif key.endswith(("running_mean", "num_batches_tracked")):
            sd[key] = torch.zeros_like(t)
        elif key.endswith("running_var") or (
                key.endswith(".weight") and module.endswith(
                    ("norm", "norm1", "norm2", "aux.1"))):
            sd[key] = torch.ones_like(t)
        elif key.endswith(".bias") or (module in heads
                                       and module not in called):
            sd[key] = torch.zeros_like(t)
        else:
            rng = np.random.default_rng([seed, zlib.crc32(key.encode())])
            w = rng.standard_normal(tuple(t.shape), dtype=np.float32)
            # redraw, in index order, every entry past the cut until none
            # is: only the entries just redrawn can still lie past it
            bad = np.flatnonzero(np.abs(w) > 2.0)
            while bad.size:
                w.flat[bad] = rng.standard_normal(bad.size, dtype=np.float32)
                bad = bad[np.abs(w.flat[bad]) > 2.0]
            sd[key] = torch.from_numpy(w * np.float32(0.02))
    return sd


def act_amax_from_flax(batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's calibrated ``batch_stats/blocks{s}_{k}/act_amax``
    as the port's buffer names (``blocks{s}.{k}.act_amax``), for
    ``S2Former.set_act_amax``."""
    out = {}
    for key, node in batch_stats.items():
        if isinstance(node, Mapping) and "act_amax" in node:
            stage, _, k = key.rpartition("_")
            out[f"{stage}.{k}.act_amax"] = torch.from_numpy(
                np.array(node["act_amax"], np.float32))
    return out


def load_reference_checkpoint(path: str, mcfg: ModelConfig) -> torch.nn.Module:
    """The port's model for ``mcfg`` (``build_model``) with the weights
    (and, for v4 and v5, the BatchNorm buffers) of a reference ``.pth``: the
    training dict ``{"net": state_dict, ...}`` or a bare state_dict, loaded
    with ``strict=True``."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = raw.get("net", raw) if isinstance(raw, dict) else raw
    if hasattr(state_dict, "state_dict"):  # a whole pickled nn.Module
        state_dict = state_dict.state_dict()
    model = build_model(mcfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def legacy_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a legacy net (``models/legacy.py``) from
    the JAX package's parameter tree: ``MLP`` (``fc1``..``fc3``),
    ``GRUAttention`` (``GRUCell_{2l}`` / ``GRUCell_{2l+1}``, layer l's
    forward and backward cells, into ``nn.GRU``'s ``*_l{l}`` and
    ``*_l{l}_reverse``: gates stacked r, z, n; ``bias_hh`` (0, 0, b_hn), as
    flax's r and z hidden denses have no bias) or
    ``SpatiallyMemorizedNetwork`` (HWIO convolutions to OIHW)."""
    sd: dict[str, np.ndarray] = {}

    def linear(key, node):
        sd[key + ".weight"] = _f32(node["kernel"]).T
        sd[key + ".bias"] = _f32(node["bias"])

    def conv(key, node):
        sd[key + ".weight"] = _f32(node["kernel"]).transpose(3, 2, 0, 1)
        sd[key + ".bias"] = _f32(node["bias"])

    cells = sorted((k for k in params if k.startswith("GRUCell_")),
                   key=lambda k: int(k.split("_")[1]))
    for i, key in enumerate(cells):
        c = params[key]
        t = f"rnn.%s_l{i // 2}" + ("_reverse" if i % 2 else "")
        sd[t % "weight_ih"] = np.concatenate(
            [_f32(c[g]["kernel"]).T for g in ("ir", "iz", "in")])
        sd[t % "weight_hh"] = np.concatenate(
            [_f32(c[g]["kernel"]).T for g in ("hr", "hz", "hn")])
        sd[t % "bias_ih"] = np.concatenate(
            [_f32(c[g]["bias"]) for g in ("ir", "iz", "in")])
        b_hn = _f32(c["hn"]["bias"])
        sd[t % "bias_hh"] = np.concatenate(
            [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    for name in ("fc1", "fc2", "fc3", "out", "reduce"):
        if name in params:
            linear(name, params[name])
    if "vgg16" in params:
        for name, node in params["vgg16"].items():
            conv(f"vgg16.{name}", node)
        for name, node in params["nonlocal"].items():
            conv(f"nonlocal.{name}", node)
    return _tensors(sd)
