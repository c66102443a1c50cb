"""Weights for the port's S2Former (v3).

``state_dict_from_flax`` maps the JAX package's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, variables["params"])``)
onto the port's ``state_dict`` — the reference layout that
``deepmerge_tpu/compat/torch_export.py`` writes, rewritten without JAX.
``init_state_dict`` makes weights of the same layout from a numpy seed, for
runs with no JAX at hand. ``load_reference_checkpoint`` reads a reference
``.pth``, and ``act_amax_from_flax`` carries the JAX package's calibrated
``w8a8-static`` activation scales across.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import check_supported, rel_pos_index


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _stages(mcfg: ModelConfig):
    g = mcfg.cube
    return [(0, mcfg.depth[0], g), (1, mcfg.depth[1], g // 2),
            (2, mcfg.depth[2], g // 4)]


def _head_shapes(mcfg: ModelConfig) -> dict[str, tuple[int, int]]:
    """(out, in) of the output projections and class head, as the reference
    constructs them (the unused projection is 100-wide)."""
    n, d = mcfg.n_scales, mcfg.embed_dim
    designed = mcfg.use_designed_features
    shapes = {
        "final_features": (100 if designed else mcfg.out_dim, n * d),
        "final_features_with_design": (
            mcfg.out_dim if designed else 100, (n + 1) * d),
    }
    if mcfg.num_classes > 0:
        shapes["head"] = (mcfg.num_classes, mcfg.out_dim)
    return shapes


def state_dict_from_flax(params: Mapping, mcfg: ModelConfig
                         ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax v3 parameter tree.

    Dense kernels (in, out) become Linear weights (out, in); the patch-embed
    kernels become (D, C, p, p) convolution weights; the designed-feature
    dense layers become (D, in, 1) Conv1d weights; output heads the flax
    tree lacks (constructed but never called) become zeros; every block gets
    its ``relative_position_index`` buffer.
    """
    check_supported(mcfg)
    sd: dict[str, np.ndarray] = {}
    d = mcfg.embed_dim

    def linear(key, node):
        sd[key + ".weight"] = _f32(node["kernel"]).T
        sd[key + ".bias"] = _f32(node["bias"])

    def norm(key, node):
        sd[key + ".weight"] = _f32(node["scale"])
        sd[key + ".bias"] = _f32(node["bias"])

    for i, s in enumerate(mcfg.input_image_scales):
        p = s // mcfg.cube
        node = params[f"patch_embed{i}"]["proj"]
        k = _f32(node["kernel"]).reshape(p, p, mcfg.in_channels, d)
        sd[f"patch_embed_blocks.{i}.proj.weight"] = k.transpose(3, 2, 0, 1)
        sd[f"patch_embed_blocks.{i}.proj.bias"] = _f32(node["bias"])

    for stage, depth, g in _stages(mcfg):
        idx = rel_pos_index((mcfg.n_scales, g, g)).astype(np.int64)
        for k in range(depth):
            f = params[f"blocks{stage}_{k}"]
            t = f"blocks{stage}.{k}"
            norm(t + ".norm1", f["norm1"])
            norm(t + ".norm2", f["norm2"])
            linear(t + ".attn.qkv", f["attn"]["qkv"])
            linear(t + ".attn.proj", f["attn"]["proj"])
            sd[t + ".attn.relative_position_bias_table"] = _f32(
                f["attn"]["rel_pos_bias_table"])
            sd[t + ".attn.relative_position_index"] = idx
            linear(t + ".mlp.fc1", f["mlp"]["Dense_0"])
            linear(t + ".mlp.fc2", f["mlp"]["Dense_1"])

    norm("norm", params["norm"])
    if "feature_embed" in params:
        for i in range(3):
            node = params["feature_embed"][f"proj{i}"]
            sd[f"feature_embed.proj{i}.weight"] = _f32(node["kernel"]).T[:, :, None]
            sd[f"feature_embed.proj{i}.bias"] = _f32(node["bias"])

    for key, (out_dim, in_dim) in _head_shapes(mcfg).items():
        if key in params:
            linear(key, params[key])
        else:
            sd[key + ".weight"] = np.zeros((out_dim, in_dim), np.float32)
            sd[key + ".bias"] = np.zeros((out_dim,), np.float32)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def init_state_dict(mcfg: ModelConfig, seed: int = 0
                    ) -> dict[str, torch.Tensor]:
    """Random weights of the port's layout from a numpy generator: weight
    matrices and bias tables truncated normal (std 0.02, cut at ±2 std),
    biases zero, LayerNorms ones/zeros. The projection and head the model
    never calls stay zero, as in an exported checkpoint."""
    from deepmerge_tpu_torch.models.s2former import S2Former

    rng = np.random.default_rng(seed)
    called = ("final_features_with_design" if mcfg.use_designed_features
              else "final_features")
    sd = {}
    for key, t in S2Former(mcfg).state_dict().items():
        if key.endswith("relative_position_index"):
            sd[key] = t
            continue
        is_norm = key == "norm.weight" or key.endswith(
            ("norm1.weight", "norm2.weight"))
        if is_norm:
            sd[key] = torch.ones_like(t)
        elif key.endswith(".bias") or (
            key.startswith(("final_features", "head"))
            and not key.startswith(called + ".")
        ):
            sd[key] = torch.zeros_like(t)
        else:
            w = rng.standard_normal(tuple(t.shape), dtype=np.float32)
            while (bad := np.abs(w) > 2.0).any():
                w[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
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


def load_reference_checkpoint(path: str, mcfg: ModelConfig):
    """A port ``S2Former`` for ``mcfg`` with the weights of a reference
    ``.pth``: the training dict ``{"net": state_dict, ...}`` or a bare
    state_dict, loaded with ``strict=True``."""
    from deepmerge_tpu_torch.models.s2former import S2Former

    raw = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = raw.get("net", raw) if isinstance(raw, dict) else raw
    if hasattr(state_dict, "state_dict"):  # a whole pickled nn.Module
        state_dict = state_dict.state_dict()
    model = S2Former(mcfg)
    model.load_state_dict(state_dict, strict=True)
    return model
