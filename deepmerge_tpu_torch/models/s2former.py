"""S2Former v3 in PyTorch (port of ``deepmerge_tpu/models/s2former.py``).

The shipped model of the family: three scales embedded onto one 8×8 token
grid each, a three-stage pyramid (8×8 → 4×4 → 2×2 per scale, with per-scale
2×2 average pooling between stages), one LayerNorm shared across the model,
and the designed-feature token joining the pooled scales before the output
projection. Module and parameter names are the reference ``state_dict``'s
(the names ``deepmerge_tpu/compat/torch_export.py`` writes), so an exported
checkpoint loads with ``strict=True``.

The blocks dispatch as the JAX package's do: stage 0 runs block by block,
one launch of the block kernel (K2) each; a later stage of more than one
block runs as one launch of the chain kernel (K3), a single-block stage on
K2 (``ops/kernels/fused_block.py``; CPU tensors take the plain versions
there). ``quantize="w8a8"`` and ``"w8a8-static"`` send the same launches to
the w8a8 kernels (K4), the weights quantized on every forward as the JAX
package quantizes them outside its kernel. ``"w8a8-static"`` needs
calibrated activation scales: ``calibrate`` runs the model once with every
block through the plain ``block_act_amax`` (no chain), keeping a running
max in each block's ``act_amax`` buffer.

``forward(..., train=True)`` is the training forward of the JAX package's
unfused block path (the configuration ``training_model`` gives): per block
flax-numerics LayerNorm, the qkv dense, the bias gathered from its table
(differentiable, so its gradient scatter-adds into the table), the
saved-probs attention (kernel K6, ``ops/kernels/fused_attention.py``), the
projection, LayerNorm, the tanh-GELU MLP and the residuals. Parameters stay
float32 and every op casts them to the compute dtype, as flax's
``dtype=bfloat16`` layers do.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from deepmerge_tpu_torch.config import Config, ModelConfig
from deepmerge_tpu_torch.ops.kernels.fused_attention import (
    fused_attention_train,
)
from deepmerge_tpu_torch.ops.kernels.fused_block import (
    LN_EPS,
    block_act_amax,
    fused_block,
    fused_block_chain,
    fused_block_chain_q8,
    fused_block_q8,
    gelu,
    quantize_block_params,
)

STATIC = "w8a8-static"


def rel_pos_index(cube: Sequence[int]) -> np.ndarray:
    """3-D Swin-style relative-position index over a (c, h, w) token cube:
    (N, N) int32, N = c·h·w, into a bias table of (2c-1)(2h-1)(2w-1) rows."""
    c, h, w = cube
    coords = np.stack(
        np.meshgrid(np.arange(c), np.arange(h), np.arange(w), indexing="ij")
    ).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64) + np.array([c - 1, h - 1, w - 1])
    strides = np.array([(2 * h - 1) * (2 * w - 1), 2 * w - 1, 1])
    return (rel * strides).sum(-1).astype(np.int32)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configurations the port cannot run
    on any device yet (each names the ROADMAP.md item that adds it)."""
    if cfg.variant != "v3":
        raise NotImplementedError(
            f"variant {cfg.variant!r}: the port runs v3 only so far "
            "(ROADMAP.md queue A: other backbones, with K7)"
        )
    if cfg.quantize.endswith("+attn"):
        raise NotImplementedError(
            f"quantize={cfg.quantize!r}: the int8 attention core is the next "
            "kernel of the port (ROADMAP.md queue B, K4a)"
        )
    if cfg.chain_stage0:
        raise NotImplementedError(
            "chain_stage0 is an experiment the port does not carry yet "
            "(ROADMAP.md queue B, the note on chain_stage0)"
        )


def training_model(cfg: Config) -> ModelConfig:
    """The model configuration training runs (the JAX package's
    ``train/loop._training_model``): quantization, the stage chain and
    ``chain_stage0`` cleared, ``fused_block`` on only where both
    ``model.fused_block`` and ``train.fused_block`` are. That last case is
    the saved-activation block kernel, which the port does not have yet."""
    mcfg = cfg.model
    if mcfg.fused_block and cfg.train.fused_block:
        raise NotImplementedError(
            "train.fused_block: the saved-activation training block kernel "
            "is ROADMAP.md queue B, K5 (with its hand backward "
            "_fused_block_bwd)"
        )
    want = dataclasses.replace(mcfg, fused_block=False, quantize="",
                               fused_stage_chain=False, chain_stage0=False)
    check_trainable(want)
    return want


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot train yet:
    the block kernel's training path (K5), and dropout, drop path or an
    attention off the fused path, which the JAX package runs through the
    attention-only kernel or XLA (K7)."""
    check_supported(cfg)
    if cfg.fused_block or cfg.quantize or cfg.fused_stage_chain:
        raise NotImplementedError(
            "training runs the unfused blocks (use training_model); the "
            "saved-activation block kernel is ROADMAP.md queue B, K5"
        )
    rates = (cfg.drop_ratio, cfg.attn_drop_ratio, cfg.drop_path_ratio)
    if any(rates) or not cfg.fused_attention:
        raise NotImplementedError(
            f"training with dropout/drop-path rates {rates} or "
            f"fused_attention={cfg.fused_attention}: that attention path is "
            "ROADMAP.md queue B, K7 (the port trains through K6 only)"
        )


def _dense(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Linear layer in x's dtype, rounding the product before the bias add
    as the JAX package's ``nn.Dense`` does."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)
    return torch.matmul(x, w.to(x.dtype).t()) + layer.bias.to(x.dtype)


def _flax_layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm`` numerics: f32 statistics with the fast variance
    E[x²] − E[x]² (clipped at 0), result in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + LN_EPS) * norm.weight.to(torch.float32)
    return ((xf - mu) * mul + norm.bias.to(torch.float32)).to(x.dtype)


class PatchEmbed(nn.Module):
    """Image → token grid: a stride-equals-kernel convolution, applied as
    reshape + matmul over (row, col, channel)-flattened patches."""

    def __init__(self, in_channels: int, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_channels, dim, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        b, h, w, c = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.weight.shape[0], -1)
        return torch.matmul(x, wt.to(x.dtype).t()) + self.proj.bias.to(x.dtype)


class FeatureEmbed(nn.Module):
    """Designed features → one token: three 1×1 Conv1d (dense over the
    feature axis), erf GELU after the first."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.proj0 = nn.Conv1d(in_dim, dim, 1)
        self.proj1 = nn.Conv1d(dim, dim, 1)
        self.proj2 = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(_dense(x, self.proj0), exact=True)
        return _dense(_dense(x, self.proj1), self.proj2)


class Attention(nn.Module):
    """Parameters of the cross-scale attention: qkv/proj projections and the
    3-D relative-position bias table with its index buffer."""

    def __init__(self, dim: int, num_heads: int, cube: tuple[int, int, int]):
        super().__init__()
        c, h, w = cube
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * c - 1) * (2 * h - 1) * (2 * w - 1), num_heads))
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(rel_pos_index(cube).astype(np.int64)),
        )

    def bias(self) -> torch.Tensor:
        """(H, N, N) attention bias gathered from the table."""
        n = self.relative_position_index.shape[0]
        idx = self.relative_position_index.reshape(-1)
        return self.relative_position_bias_table[idx].reshape(
            n, n, self.num_heads
        ).permute(2, 0, 1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class CrossScaleBlock(nn.Module):
    """Pre-LN attention + MLP block. Its parameters feed the block kernels
    as the 13-tuple of ``fused_params`` (the w8a8 ones as
    ``quant_params``); ``forward`` is the single-block dispatch point (K2,
    or K4 when quantized, on CUDA)."""

    def __init__(self, cfg: ModelConfig, cube: tuple[int, int, int]):
        super().__init__()
        dim = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.exact_gelu = cfg.exact_gelu
        self.kernel_eligible = (
            cfg.fused_block and cfg.fused_attention and not cfg.exact_gelu
            and cfg.drop_ratio == 0.0 and cfg.attn_drop_ratio == 0.0
            and cfg.drop_path_ratio == 0.0
        )
        # as in the JAX package, quantization rides the block kernels only
        self.quantize = cfg.quantize if self.kernel_eligible else ""
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, cfg.num_heads, cube)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio))
        if self.quantize == STATIC:
            # calibrated abs-maxes of the seven quantized activations; not
            # in the state_dict, so reference checkpoints load strictly
            self.register_buffer("act_amax", torch.zeros(7), persistent=False)

    def fused_params(self, dtype: torch.dtype) -> tuple:
        """The block kernels' 13-tuple: LayerNorm parameters and attention
        bias widened to f32, everything else in ``dtype``."""
        f32 = lambda t: t.to(torch.float32).contiguous()
        w = lambda t: t.to(dtype).contiguous()
        a, m = self.attn, self.mlp
        return (
            f32(self.norm1.weight), f32(self.norm1.bias),
            w(a.qkv.weight), w(a.qkv.bias), f32(a.bias()),
            w(a.proj.weight), w(a.proj.bias),
            f32(self.norm2.weight), f32(self.norm2.bias),
            w(m.fc1.weight), w(m.fc1.bias), w(m.fc2.weight), w(m.fc2.bias),
        )

    def quant_params(self, dtype: torch.dtype) -> tuple:
        """The w8a8 kernels' 17-tuple (18 with the static scales), the
        weights quantized from their ``dtype`` values."""
        amax = self.act_amax if self.quantize == STATIC else None
        return quantize_block_params(self.fused_params(dtype), amax)

    def check_device(self, x: torch.Tensor) -> None:
        if x.device.type == "cuda" and not self.kernel_eligible:
            raise NotImplementedError(
                "on CUDA the blocks run only through the fused block kernels "
                "(fused_block and fused_attention on, tanh GELU, no "
                "dropout); the attention-only kernel path is ROADMAP.md "
                "queue B, K7"
            )

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                calibrate: bool = False, train: bool = False) -> torch.Tensor:
        """One block. ``calibrate`` (``w8a8-static``) runs the plain
        calibration forward instead and folds its abs-maxes into
        ``act_amax``; ``train`` runs the training forward."""
        if train:
            return self.train_forward(x, dtype)
        self.check_device(x)
        x = x.to(dtype)
        heads, exact = self.num_heads, self.exact_gelu
        if not self.quantize:
            return fused_block(x, self.fused_params(dtype), heads=heads,
                               exact_gelu=exact)
        if calibrate:
            out, amax = block_act_amax(x, self.fused_params(dtype), heads,
                                       exact)
            self.act_amax.copy_(torch.maximum(self.act_amax, amax))
            return out.to(dtype)
        return fused_block_q8(x, self.quant_params(dtype), heads=heads,
                              exact_gelu=exact)

    def train_forward(self, x: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """The JAX package's unfused block in training
        (``CrossScaleBlock.__call__`` with ``deterministic=False``): every
        dense in ``dtype`` from the float32 parameters, the attention
        through ``fused_attention_train`` (K6 on CUDA)."""
        x = x.to(dtype)
        y = _flax_layer_norm(x, self.norm1)
        qkv = _dense(y, self.attn.qkv)
        a = fused_attention_train(qkv, self.attn.bias(), self.num_heads)
        x = x + _dense(a, self.attn.proj)
        y = _flax_layer_norm(x, self.norm2)
        y = gelu(_dense(y, self.mlp.fc1), exact=self.exact_gelu)
        return x + _dense(y, self.mlp.fc2)


def _pool2x2_per_scale(x: torch.Tensor, n_scales: int, grid: int):
    """Per-scale 2×2 average pooling of the token cube:
    (B, n·g², D) → (B, n·(g/2)², D)."""
    b, _, d = x.shape
    g = grid
    x = x.reshape(b, n_scales, g // 2, 2, g // 2, 2, d).mean(dim=(3, 5))
    return x.reshape(b, n_scales * (g // 2) ** 2, d)


class S2Former(nn.Module):
    """S2Former v3: ``forward(patches, designed)`` → (B, out_dim)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        n, g, dim = cfg.n_scales, cfg.cube, cfg.embed_dim
        self.dtype = getattr(torch, cfg.dtype)
        self.patch_embed_blocks = nn.ModuleList(
            PatchEmbed(cfg.in_channels, s // g, dim)
            for s in cfg.input_image_scales
        )
        if cfg.use_designed_features:
            self.feature_embed = FeatureEmbed(cfg.designed_feature_dim, dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.blocks0 = nn.ModuleList(
            CrossScaleBlock(cfg, (n, g, g)) for _ in range(cfg.depth[0]))
        self.blocks1 = nn.ModuleList(
            CrossScaleBlock(cfg, (n, g // 2, g // 2))
            for _ in range(cfg.depth[1]))
        self.blocks2 = nn.ModuleList(
            CrossScaleBlock(cfg, (n, g // 4, g // 4))
            for _ in range(cfg.depth[2]))
        # the reference constructs both output projections and a class head
        # whatever the configuration (unused ones export as zeros); the
        # unused projection is 100-wide, as the reference constructs it
        designed = cfg.use_designed_features
        self.final_features = nn.Linear(
            n * dim, 100 if designed else cfg.out_dim)
        self.final_features_with_design = nn.Linear(
            (n + 1) * dim, cfg.out_dim if designed else 100)
        if cfg.num_classes > 0:
            self.head = nn.Linear(cfg.out_dim, cfg.num_classes)
        self.calibrating = False
        self.act_amax_calibrated = False

    def _stage(self, blocks: nn.ModuleList, x: torch.Tensor,
               chain: bool, train: bool = False) -> torch.Tensor:
        """A stage as one chain launch when ``chain`` is on and it has more
        than one block, else block by block (always while calibrating, so
        that each block records its own abs-maxes, and in training)."""
        if not len(blocks):
            return x
        x = x.to(self.dtype)
        if train:
            for blk in blocks:
                x = blk(x, self.dtype, train=True)
            return x
        if chain and len(blocks) > 1 and not self.calibrating:
            blocks[0].check_device(x)
            kw = dict(heads=self.cfg.num_heads,
                      exact_gelu=self.cfg.exact_gelu)
            if blocks[0].quantize:
                return fused_block_chain_q8(
                    x, [blk.quant_params(self.dtype) for blk in blocks], **kw)
            return fused_block_chain(
                x, [blk.fused_params(self.dtype) for blk in blocks], **kw)
        for blk in blocks:
            x = blk(x, self.dtype, calibrate=self.calibrating)
        return x

    def _static_blocks(self):
        return [b for b in (*self.blocks0, *self.blocks1, *self.blocks2)
                if b.quantize == STATIC]

    @torch.inference_mode()
    def calibrate(self, patches, designed=None) -> None:
        """``w8a8-static`` calibration on one batch: a forward with every
        block through ``block_act_amax``, each block's ``act_amax`` raised
        to the batch's abs-maxes. Later forwards serve with the scales."""
        self.calibrating = True
        try:
            self(patches, designed)
        finally:
            self.calibrating = False
        self.act_amax_calibrated = True

    def set_act_amax(self, amax: dict) -> None:
        """Load calibrated abs-maxes, ``{"blocks0.0.act_amax": (7,), ...}``
        (see ``compat.weights.act_amax_from_flax``), for every block."""
        blocks = {n: m for n, m in self.named_modules()
                  if isinstance(m, CrossScaleBlock) and m.quantize == STATIC}
        missing = sorted(set(f"{n}.act_amax" for n in blocks) - set(amax))
        if missing:
            raise KeyError(f"no calibrated act_amax for {missing}")
        for n, blk in blocks.items():
            blk.act_amax.copy_(torch.as_tensor(amax[f"{n}.act_amax"]))
        self.act_amax_calibrated = True

    def forward(self, patches, designed=None,
                train: bool = False) -> torch.Tensor:
        """Embeddings (B, out_dim). ``train`` is the JAX package's ``train``
        argument: the training forward, whose blocks run through K6."""
        cfg = self.cfg
        if train:
            check_trainable(cfg)
        elif (self._static_blocks() and not self.calibrating
                and not self.act_amax_calibrated):
            raise ValueError(
                "model.quantize='w8a8-static' needs calibrated activation "
                "scales: run inference through FeatureExtractor (it "
                "calibrates on the first chunk), call calibrate(), or load "
                "them with set_act_amax()"
            )
        n, g = cfg.n_scales, cfg.cube
        x = torch.cat(
            [pe(p.to(self.dtype))
             for pe, p in zip(self.patch_embed_blocks, patches)], dim=1
        )
        chain = cfg.fused_stage_chain
        # stage 0 runs block by block (chain_stage0 is not supported)
        x = self._stage(self.blocks0, x, False, train)
        x = _flax_layer_norm(_pool2x2_per_scale(x, n, g), self.norm)
        x = self._stage(self.blocks1, x, chain, train)
        x = _flax_layer_norm(_pool2x2_per_scale(x, n, g // 2), self.norm)
        x = self._stage(self.blocks2, x, chain, train)
        x = _flax_layer_norm(x, self.norm)
        b, _, d = x.shape
        g2 = (g // 4) ** 2
        pooled = x[:, : n * g2].reshape(b, n, g2, d).mean(dim=2).reshape(b, n * d)
        if cfg.use_designed_features:
            t = _flax_layer_norm(
                self.feature_embed(designed.to(self.dtype)), self.norm)
            return _dense(torch.cat([pooled, t], dim=-1),
                          self.final_features_with_design)
        return _dense(pooled, self.final_features)
