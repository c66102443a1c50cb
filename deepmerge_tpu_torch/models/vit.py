"""ViT and the multi-scale ScaleEmbedTransformer in PyTorch (port of
``deepmerge_tpu/models/vit.py``; reference ``vit_model.py``).

The precursor family to S2Former: a timm-style ``VisionTransformer``
(``vit_model.py:188-317``) and the ``ScaleEmbedTransformer``
(``:321-549``) — four fixed patch embeds (28/4, 56/8, 112/16, 224/32 → 49
tokens each), per-scale learned position embeddings multiplied by the
sample's scale factors, a cls token, an optional designed-feature token and
an optional label token with its class head. ``ScaleEmbedBackbone`` makes
the latter the pipeline backbone of ``ModelConfig(variant="vit")``.

Module and parameter names are the reference ``state_dict``'s
(``blocks.{i}.attn.qkv``, ``patch_embed{i}.proj``, ``pos_embed{i}``,
``cls_token``, ``feature_embed.proj{k}``, ``my_head``, ``pre_logits.fc``,
...), the keys ``compat/vit_import.load_torch_vit`` reads, so a reference
``.pth`` loads as it is.

The numerics are the JAX package's: flax LayerNorm (eps 1e-6, the variance
E[x²] − E[x]²), every dense in the compute dtype from float32 parameters,
q scaled in the compute dtype, the logits and the softmax in float32, the
probabilities cast to the compute dtype, P·V summed in float32 and cast
back. The attention is plain PyTorch: the JAX vit reaches no Pallas kernel.
The block MLP's GELU is the tanh form unless ``exact_gelu``; the label
head's is erf. Dropout and drop path draw from the ``generator`` passed to
``forward(..., train=True)``. As in the JAX package, the forward is
single-branch: Siamese pairing is the caller's batch stacking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepmerge_tpu_torch.config import ModelConfig
from deepmerge_tpu_torch.models.s2former import (
    FeatureEmbed,
    Mlp,
    PatchEmbed,
    VIT_SCALES,
    _dense,
    _flax_layer_norm,
)
from deepmerge_tpu_torch.ops.dropout import drop_path, dropout
from deepmerge_tpu_torch.ops.kernels.fused_block import gelu

LN_EPS = 1e-6
ATTENTION_RANGE = "vit.attention_core"


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Attention(nn.Module):
    """Multi-head self-attention without a relative bias
    (``vit.py:28-58``)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = _dense(x, self.qkv).reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # (B, H, N, D) in x's dtype
        # the scale rounded to x's dtype, as JAX multiplies a weakly typed
        # constant; then a correctly rounded product, as XLA's
        scale = torch.tensor(d ** -0.5, dtype=x.dtype).item()
        f32 = torch.float32
        # a named range, so that a profile can attribute the core's time
        with torch.profiler.record_function(ATTENTION_RANGE):
            logits = torch.matmul((q * scale).to(f32),
                                  k.to(f32).transpose(-1, -2))
            p = torch.softmax(logits, dim=-1).to(x.dtype)
            if train:
                p = dropout(p, self.attn_drop, generator)
            out = torch.matmul(p.to(f32), v.to(f32))
            out = out.transpose(1, 2).reshape(b, n, c).to(x.dtype)
        out = _dense(out, self.proj)
        return dropout(out, self.proj_drop, generator) if train else out


class Block(nn.Module):
    """Pre-LN attention + MLP block (``vit.py:61-83``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, exact_gelu: bool = False):
        super().__init__()
        self.drop, self.drop_path = drop, drop_path
        self.exact_gelu = exact_gelu
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, attn_drop=attn_drop,
                              proj_drop=drop)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        g = generator
        drop = (lambda t: dropout(t, self.drop, g)) if train else _identity
        dpath = ((lambda t: drop_path(t, self.drop_path, g)) if train
                 else _identity)
        x = x + dpath(self.attn(_flax_layer_norm(x, self.norm1), train, g))
        y = gelu(_dense(_flax_layer_norm(x, self.norm2), self.mlp.fc1),
                 exact=self.exact_gelu)
        return x + dpath(drop(_dense(drop(y), self.mlp.fc2)))


def _blocks(dim: int, depth: int, num_heads: int, mlp_ratio: float,
            drop: float, attn_drop: float, drop_path_ratio: float,
            exact_gelu: bool) -> nn.ModuleList:
    dpr = np.linspace(0, drop_path_ratio, depth)
    return nn.ModuleList(
        Block(dim, num_heads, mlp_ratio, drop, attn_drop, float(dpr[i]),
              exact_gelu)
        for i in range(depth))


def _token(dim: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros((1, 1, dim)))


class _PreLogits(nn.Module):
    """``pre_logits``: a dense layer (named ``fc``, as the reference's
    ``nn.Sequential``) and tanh."""

    def __init__(self, dim: int, size: int):
        super().__init__()
        self.fc = nn.Linear(dim, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(_dense(x, self.fc))


class VisionTransformer(nn.Module):
    """Plain ViT encoder (``vit.py:86-130``), NHWC input; returns the class
    logits, or the (pre-logits) cls feature with ``num_classes=0``."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_c: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 representation_size: Optional[int] = None,
                 drop_ratio: float = 0.0, attn_drop_ratio: float = 0.0,
                 drop_path_ratio: float = 0.0, exact_gelu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.drop_ratio = dtype, drop_ratio
        self.patch_embed = PatchEmbed(in_c, patch_size, embed_dim)
        self.cls_token = _token(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, (img_size // patch_size) ** 2 + 1, embed_dim)))
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              drop_ratio, attn_drop_ratio, drop_path_ratio,
                              exact_gelu)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        width = embed_dim
        if representation_size:
            self.pre_logits = _PreLogits(embed_dim, representation_size)
            width = representation_size
        if num_classes > 0:
            self.head = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if train:
            x = dropout(x, self.drop_ratio, generator)
        for blk in self.blocks:
            x = blk(x, train, generator)
        feat = _flax_layer_norm(x, self.norm)[:, 0]
        if hasattr(self, "pre_logits"):
            feat = self.pre_logits(feat)
        return _dense(feat, self.head) if hasattr(self, "head") else feat


class ScaleEmbedTransformer(nn.Module):
    """Multi-scale ViT with scale-modulated position embeddings
    (``vit.py:133-218``).

    ``forward(patches, designed, factors, train)``: ``patches`` the 4 NHWC
    tensors at 28/56/112/224, ``designed`` (B, ``designed_dim``) or None,
    ``factors`` (B, 4) multiplying each scale's position-embedded tokens
    (ones when None), in the compute dtype (the JAX package's backbone
    casts them so; ``vit.py:328-330``). Returns the ``out_dim`` embedding, plus
    ``(class_logits, class_feat)`` with ``label_embed``. Token order: cls,
    label (``label_embed``), the designed-feature token
    (``feature_embed``), then the 4 × 49 scale tokens."""

    IMG_SIZES = VIT_SCALES
    PATCH_SIZES = (4, 8, 16, 32)

    def __init__(self, num_classes: int = 11, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 out_dim: int = 100, feature_embed: bool = True,
                 label_embed: bool = False, drop_ratio: float = 0.0,
                 attn_drop_ratio: float = 0.0, drop_path_ratio: float = 0.0,
                 exact_gelu: bool = False, dtype: torch.dtype = torch.float32,
                 in_c: int = 3, designed_dim: int = 19):
        super().__init__()
        self.dtype, self.drop_ratio = dtype, drop_ratio
        self.label_embed = label_embed
        for i, (sz, ps) in enumerate(zip(self.IMG_SIZES, self.PATCH_SIZES)):
            self.add_module(f"patch_embed{i}", PatchEmbed(in_c, ps, embed_dim))
            self.register_parameter(f"pos_embed{i}", nn.Parameter(
                torch.zeros((1, (sz // ps) ** 2, embed_dim))))
        self.cls_token = _token(embed_dim)
        if label_embed:
            self.label_token = _token(embed_dim)
        if feature_embed:
            self.feature_embed = FeatureEmbed(designed_dim, embed_dim)
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              drop_ratio, attn_drop_ratio, drop_path_ratio,
                              exact_gelu)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.my_head = nn.Linear(embed_dim, out_dim)
        if label_embed:
            self.class_fc1 = nn.Linear(embed_dim, out_dim)
            self.class_fc2 = nn.Linear(out_dim, out_dim)
            self.class_logits = nn.Linear(out_dim, num_classes)

    def forward(self, patches: Sequence[torch.Tensor],
                designed: Optional[torch.Tensor] = None,
                factors: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        dt, g = self.dtype, generator
        b = patches[0].shape[0]
        if factors is None:
            factors = torch.ones((b, 4), dtype=dt, device=patches[0].device)
        factors = factors.to(dt)
        toks = [
            (getattr(self, f"patch_embed{i}")(p.to(dt))
             + getattr(self, f"pos_embed{i}").to(dt))
            * factors[:, i, None, None]
            for i, p in enumerate(patches)
        ]
        lead = [self.cls_token.to(dt).expand(b, -1, -1)]
        if self.label_embed:
            lead.append(self.label_token.to(dt).expand(b, -1, -1))
        if hasattr(self, "feature_embed"):
            lead.append(self.feature_embed(designed.to(dt))[:, None, :])
        x = torch.cat(lead + toks, dim=1)
        if train:
            x = dropout(x, self.drop_ratio, g)
        for blk in self.blocks:
            x = blk(x, train, g)
        x = _flax_layer_norm(x, self.norm)
        emb = _dense(x[:, 0], self.my_head)
        if not self.label_embed:
            return emb
        cf = gelu(_dense(x[:, 1], self.class_fc1), exact=True)
        if train:
            cf = dropout(cf, 0.3, g)
        class_feat = _dense(cf, self.class_fc2)
        return emb, _dense(class_feat, self.class_logits), class_feat


# ---------------------------------------------------------------------------
# Factories (reference ``vit_model.py:568-661``). Pretrained google-research
# ``.pth`` weights load with ``compat.vit_import.load_torch_vit``.
# ---------------------------------------------------------------------------


def vit_base_patch_scales_224_in21k(
    num_classes: int = 21843, has_logits: bool = True,
    is_feature_embed: bool = True, is_label_embed: bool = False, **kw,
) -> ScaleEmbedTransformer:
    """The multi-scale variant (``vit_model.py:568-578``). ``num_classes``
    does not size the class head: the reference pins it at 11
    (``vit_model.py:408-411``)."""
    return ScaleEmbedTransformer(
        num_classes=11, embed_dim=768, depth=12, num_heads=12,
        feature_embed=is_feature_embed, label_embed=is_label_embed, **kw,
    )


def _vit(patch: int, dim: int, depth: int, heads: int, num_classes: int,
         has_logits: bool, **kw) -> VisionTransformer:
    return VisionTransformer(
        img_size=224, patch_size=patch, embed_dim=dim, depth=depth,
        num_heads=heads, representation_size=dim if has_logits else None,
        num_classes=num_classes, **kw)


def vit_base_patch16_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True, **kw):
    """ViT-B/16, ImageNet-21k layout (``vit_model.py:582-597``)."""
    return _vit(16, 768, 12, 12, num_classes, has_logits, **kw)


def vit_base_patch32_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True, **kw):
    """ViT-B/32 (``vit_model.py:599-614``)."""
    return _vit(32, 768, 12, 12, num_classes, has_logits, **kw)


def vit_large_patch16_224_in21k(num_classes: int = 21843,
                                has_logits: bool = True, **kw):
    """ViT-L/16 (``vit_model.py:617-631``)."""
    return _vit(16, 1024, 24, 16, num_classes, has_logits, **kw)


def vit_large_patch32_224_in21k(num_classes: int = 21843,
                                has_logits: bool = True, **kw):
    """ViT-L/32 (``vit_model.py:633-647``)."""
    return _vit(32, 1024, 24, 16, num_classes, has_logits, **kw)


def vit_huge_patch14_224_in21k(num_classes: int = 21843,
                               has_logits: bool = True, **kw):
    """ViT-H/14 (``vit_model.py:650-661``)."""
    return _vit(14, 1280, 32, 16, num_classes, has_logits, **kw)


class ScaleEmbedBackbone(ScaleEmbedTransformer):
    """The ScaleEmbedTransformer as the pipeline's backbone,
    ``forward(patches, designed, train)`` → embedding (``vit.py:288-331``).

    The pipeline passes one designed vector whose trailing four entries are
    the per-scale factors (``MyUtils1.py:151-156``), so the backbone slices
    them for the position-embedding scaling. Its depth is ``sum(depth)``,
    its dtype the config's, no label head. Needs ``input_image_scales ==
    (28, 56, 112, 224)`` (``build_model`` checks) and four real patch
    slots. Nothing of it is quantized: ``model.quantize`` is a no-op for
    this variant (the config warns), so it never calibrates."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(
            num_classes=cfg.num_classes, embed_dim=cfg.embed_dim,
            depth=sum(cfg.depth), num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio, out_dim=cfg.out_dim,
            feature_embed=cfg.use_designed_features, label_embed=False,
            drop_ratio=cfg.drop_ratio, attn_drop_ratio=cfg.attn_drop_ratio,
            drop_path_ratio=cfg.drop_path_ratio, exact_gelu=cfg.exact_gelu,
            dtype=getattr(torch, cfg.dtype), in_c=cfg.in_channels,
            designed_dim=cfg.designed_feature_dim)
        self.cfg = cfg

    def forward(self, patches, designed=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        factors = None if designed is None else designed[:, -4:]
        return super().forward(tuple(patches), designed, factors, train,
                               generator)
