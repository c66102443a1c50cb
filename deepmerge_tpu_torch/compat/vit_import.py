"""timm-style pretrained ViT checkpoints for the port's ViT family (port of
``deepmerge_tpu/compat/vit_import.py``).

The reference loads google-research ViT ``.pth`` weights with
``load_state_dict(strict=False)`` after deleting the head keys
(``vit_model.py:664-707``): the head alone when ``has_logits``, plus
``patch_embed`` and ``pre_logits`` otherwise. The port's modules carry the
reference's parameter names, so ``load_torch_vit`` is that partial load,
with the JAX package's report: keys with no home or of another shape are
skipped, parameters the checkpoint does not cover keep their values.

``vit_state_dict_from_flax`` carries the JAX package's ViT parameters
across: the inverse of its ``map_vit_key``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# reference del_keys (vit_model.py:696-699)
DEL_KEYS_LOGITS = ("head.weight", "head.bias")
DEL_KEYS_NO_LOGITS = (
    "patch_embed.proj.weight", "patch_embed.proj.bias",
    "pre_logits.fc.weight", "pre_logits.fc.bias",
    "head.weight", "head.bias",
)

_LINEARS = ("head", "my_head", "class_fc1", "class_fc2", "class_logits")
_FC = {"Dense_0": "fc1", "Dense_1": "fc2"}


def load_torch_vit(model: torch.nn.Module, state_dict: Mapping[str, Any],
                   has_logits: bool = True, drop_head: bool = True) -> dict:
    """Partial-load a torch ViT ``state_dict`` into ``model`` (a
    ``VisionTransformer``, ``ScaleEmbedTransformer`` or
    ``ScaleEmbedBackbone``), in place.

    Returns the report ``{"loaded", "missing", "skipped"}``: the keys
    loaded; the model's keys the checkpoint did not cover (they keep their
    values); and the checkpoint's keys with no home in the model or of
    another shape (``"key (shape (a, b) != (c, d))"``), mirroring torch's
    ``strict=False`` printout the reference relies on (``vit_model.py:701``).
    """
    del_keys = (
        (DEL_KEYS_LOGITS if has_logits else DEL_KEYS_NO_LOGITS)
        if drop_head else ()
    )
    own = model.state_dict()
    take, skipped = {}, []
    for k, v in state_dict.items():
        if k in del_keys:
            continue
        if k not in own:
            skipped.append(k)
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(own[k].shape):
            skipped.append(
                f"{k} (shape {tuple(v.shape)} != {tuple(own[k].shape)})")
            continue
        take[k] = v.to(own[k].dtype)
    model.load_state_dict(take, strict=False)
    return {"loaded": list(take),
            "missing": [k for k in own if k not in take],
            "skipped": skipped}


def vit_state_dict_from_flax(tree: Mapping, in_channels: int = 3
                             ) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` of a flax ``VisionTransformer`` or
    ``ScaleEmbedTransformer`` parameter tree (nested dicts of arrays; for
    the pipeline backbone the tree under ``"vit"``): dense kernels (in, out)
    become Linear weights (out, in), the patch-embed kernels (p·p·C, D)
    convolution weights (D, C, p, p), the designed-feature dense layers
    Conv1d weights (D, in, 1), ``block{i}`` becomes ``blocks.{i}`` and the
    MLP's ``Dense_0`` / ``Dense_1`` ``fc1`` / ``fc2``."""
    f32 = lambda a: np.asarray(a, np.float32)
    sd: dict[str, np.ndarray] = {}

    def linear(key, node):
        sd[key + ".weight"] = f32(node["kernel"]).T
        sd[key + ".bias"] = f32(node["bias"])

    def norm(key, node):
        sd[key + ".weight"] = f32(node["scale"])
        sd[key + ".bias"] = f32(node["bias"])

    for name, node in tree.items():
        if not isinstance(node, Mapping):  # tokens, position embeddings
            sd[name] = f32(node)
        elif name.startswith("patch_embed"):
            k = f32(node["proj"]["kernel"])
            d = k.shape[1]
            p = int(round((k.shape[0] / in_channels) ** 0.5))
            sd[name + ".proj.weight"] = k.reshape(
                p, p, in_channels, d).transpose(3, 2, 0, 1)
            sd[name + ".proj.bias"] = f32(node["proj"]["bias"])
        elif name.startswith("block"):
            t = f"blocks.{name[len('block'):]}"
            norm(t + ".norm1", node["norm1"])
            norm(t + ".norm2", node["norm2"])
            for lin in ("qkv", "proj"):
                sub = node["attn"][lin]
                sd[f"{t}.attn.{lin}.weight"] = f32(sub["kernel"]).T
                if "bias" in sub:
                    sd[f"{t}.attn.{lin}.bias"] = f32(sub["bias"])
            for dense, fc in _FC.items():
                linear(f"{t}.mlp.{fc}", node["mlp"][dense])
        elif name == "norm":
            norm("norm", node)
        elif name == "pre_logits":
            linear("pre_logits.fc", node)
        elif name in _LINEARS:
            linear(name, node)
        elif name == "feature_embed":
            for i in range(3):
                sub = node[f"proj{i}"]
                sd[f"feature_embed.proj{i}.weight"] = \
                    f32(sub["kernel"]).T[:, :, None]
                sd[f"feature_embed.proj{i}.bias"] = f32(sub["bias"])
        else:
            raise KeyError(f"no port home for the flax ViT parameter {name!r}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
