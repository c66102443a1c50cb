"""The S2Former family, v1–v6, in PyTorch (port of
``deepmerge_tpu/models/s2former.py``).

Every scale is embedded onto one cube×cube token grid and the blocks attend
over the concatenated multi-scale sequence with a 3-D relative-position
bias over the (scale, row, col) cube. The variants, as the JAX package's:

* v1: four fixed scales, one stage of blocks (drop path rising linearly
  over them), per-scale mean-pool head; v2: any scales, one stage.
* v3, the shipped model: a three-stage pyramid (8×8 → 4×4 → 2×2 per scale,
  per-scale 2×2 average pooling between stages), one LayerNorm shared
  across the model, the designed-feature token joining the pooled scales
  before the output projection.
* v4: v3 with two deep-supervision heads (``AuxBlock``) after stages 0 and
  1, which run in training only.
* v5: v4 with the designed-feature token appended to the sequence and
  carried through the stages (N = 193/49/13 at the defaults), its bias
  table extended by ``rel_pos_index_extra_token``.
* v6: the designed features alone through an MLP (an ablation).

Module and parameter names are the reference ``state_dict``'s (the names
``deepmerge_tpu/compat/torch_export.py`` writes), so an exported checkpoint
loads with ``strict=True``.

Inference dispatches the blocks as the JAX package does. A block on the
block kernel (``fused_block`` and ``fused_attention`` on, tanh GELU, no
dropout or drop path) runs as one launch of K2, and a later stage of more
than one such block as one launch of the chain kernel K3
(``ops/kernels/fused_block.py``); ``quantize="w8a8"`` and
``"w8a8-static"`` send the same launches to the w8a8 kernels (K4), the
weights quantized on every forward as the JAX package quantizes them
outside its kernel, and ``"w8a8+attn"`` to the same kernels with the int8
attention core (K4a). ``"w8a8-static"`` needs calibrated activation scales:
``calibrate`` runs the model once with every block through the plain
``block_act_amax`` (no chain), keeping a running max in each block's
``act_amax`` buffer. Any other block runs unfused: flax-numerics
LayerNorm, the qkv dense, the attention-only kernel K7
(``ops/kernels/fused_attention.py``), the projection, LayerNorm, the GELU
MLP. Quantization rides the block kernels only: on a block off them it is
a no-op, as in the JAX package (whose config warns).

``forward(..., train=True)`` is the training forward of the configuration
``training_model`` gives, block by block: a block on the block kernel
through the differentiable ``fused_block`` (the saved-activation training
block K5 and its hand backward, with ``train.fused_block``), any other
unfused with the attention through the saved-probs kernel K6; it returns
``(out, aux0, aux1)`` for v4 and v5. Dropout, drop path and the aux heads'
Dropout2d draw their masks from the ``generator`` passed in (JAX's
``fold_in`` streams cannot be reproduced). The aux heads' BatchNorm
normalizes with the batch statistics and updates its running buffers in
place, with flax's numerics. Parameters stay float32 and every op casts
them to the compute dtype, as flax's ``dtype=bfloat16`` layers do.

Built for a mesh with a model axis of n > 1 (``S2Former(cfg, mesh)``),
the model is tensor parallel, as the JAX package's ``shard_params`` makes
it under GSPMD: each ``CrossScaleBlock`` holds H/n heads and the slices of
``parallel.mesh.shard_params`` (which load strictly), and runs unfused
whatever ``fused_block`` says (the block kernels take whole weights),
its attention through K7 (K6 in training) on the local heads. proj's and
fc2's partial products stay float32 until their SUM over the model axis,
then round as the replicated model's products do and take the full bias.
Dropout masks on sliced activations (the attention's, the MLP hidden's)
are the whole model's, cut to the slice. Quantization under n > 1
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from deepmerge_tpu_torch.config import KNOWN_VARIANTS, Config, ModelConfig
from deepmerge_tpu_torch.ops.dropout import _uniform, drop_path, dropout
from deepmerge_tpu_torch.ops.kernels.fused_attention import (
    attention_bnhd_ref,
    fused_attention_qkv,
    fused_attention_train,
    split_qkv,
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
from deepmerge_tpu_torch.parallel.mesh import (
    BatchShard,
    Mesh,
    all_reduce_sum,
    copy_to_model,
    reduce_from_model,
)

STATIC = "w8a8-static"
# flax nn.BatchNorm's defaults: running = 0.99·running + 0.01·batch
BN_MOMENTUM = 0.99
BN_EPS = 1e-5


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


def rel_pos_index_extra_token(cube: Sequence[int]) -> tuple[np.ndarray, int]:
    """v5's index, one extra (designed-feature) token appended to the cube,
    as the reference builds it: a fresh row of the table for every
    (token → extra) entry, then one for every (extra → token) entry, and
    ``index[-1, -1] = index[0, 0]``. Returns the (N+1, N+1) int32 index and
    the table size (2c-1)(2h-1)(2w-1) + 2N."""
    c, h, w = cube
    n = c * h * w
    base = rel_pos_index(cube).astype(np.int64)
    idx = np.concatenate(
        [base, base.max() + 1 + np.arange(n).reshape(n, 1)], axis=1)
    idx = np.concatenate(
        [idx, idx.max() + 1 + np.arange(n + 1).reshape(1, n + 1)], axis=0)
    idx[-1, -1] = idx[0, 0]
    table = (2 * c - 1) * (2 * h - 1) * (2 * w - 1) + 2 * n
    return idx.astype(np.int32), int(table)


def bias_index(cube: Sequence[int], extra_token: bool = False
               ) -> tuple[np.ndarray, int]:
    """The attention bias's index over a cube and its table size."""
    if extra_token:
        return rel_pos_index_extra_token(cube)
    c, h, w = cube
    return rel_pos_index(cube), (2 * c - 1) * (2 * h - 1) * (2 * w - 1)


VIT_SCALES = (28, 56, 112, 224)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations the port cannot build: ``ValueError`` for
    what the JAX package's ``build_model`` refuses, ``NotImplementedError``
    for what it has not ported yet (naming its ROADMAP.md item)."""
    if cfg.variant == "vit":
        if tuple(cfg.input_image_scales) != VIT_SCALES:
            raise ValueError(
                "variant='vit' uses the ScaleEmbedTransformer's FIXED "
                "patch-embed sizes: set model.input_image_scales=28,56,112,"
                "224 (and data.patch_sizes to match) — got "
                f"{tuple(cfg.input_image_scales)} (vit_model.py:359-362)"
            )
        return
    if cfg.variant not in KNOWN_VARIANTS:
        raise ValueError(
            f"unknown model.variant {cfg.variant!r} "
            f"(known: {sorted(KNOWN_VARIANTS)}) — when adding a variant, "
            "also add it to config.CROSS_SCALE_BLOCK_VARIANTS if its "
            "backbone uses CrossScaleBlocks (megakernel/quantize eligibility)"
        )
    if cfg.variant == "v1" and cfg.n_scales != 4:
        raise ValueError(f"v1 uses 4 fixed scales, got "
                         f"{cfg.input_image_scales}")
    if cfg.chain_stage0:
        raise NotImplementedError(
            "chain_stage0 is an experiment the port does not carry yet "
            "(ROADMAP.md queue B, the note on chain_stage0)"
        )


def check_tensor_parallel(cfg: ModelConfig, n_model: int) -> None:
    """Raise ``ValueError`` for a model that cannot be split over
    ``n_model`` ranks: a quantized one (the w8a8 kernels take whole
    weights, ROADMAP.md B6), or heads and hidden units that do not
    divide."""
    if cfg.quantize:
        raise ValueError(
            f"model.quantize={cfg.quantize!r} under tensor parallelism "
            f"(a model axis of {n_model}): the w8a8 kernels take whole "
            "weights; serve a quantized model with n_model 1 (ROADMAP.md B6)")
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    if cfg.num_heads % n_model or hidden % n_model:
        raise ValueError(
            f"tensor parallelism over {n_model} ranks needs the heads "
            f"({cfg.num_heads}) and the MLP's hidden units ({hidden}) to "
            "divide")


def training_model(cfg: Config) -> ModelConfig:
    """The model configuration training runs (the JAX package's
    ``train/loop._training_model``): quantization, the stage chain and
    ``chain_stage0`` cleared, ``fused_block`` on only where both
    ``model.fused_block`` and ``train.fused_block`` are (the
    saved-activation training block, K5)."""
    mcfg = cfg.model
    want = dataclasses.replace(
        mcfg, fused_block=mcfg.fused_block and cfg.train.fused_block,
        quantize="", fused_stage_chain=False, chain_stage0=False)
    check_trainable(want)
    return want


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a model the port cannot train: a
    quantized one (the w8a8 kernels are inference-only) or one on the
    stage chain (training runs block by block); ``training_model`` clears
    both."""
    check_supported(cfg)
    if cfg.quantize or cfg.fused_stage_chain:
        raise NotImplementedError(
            "training runs without quantization and without the stage "
            "chain: train the model of training_model(cfg)"
        )


def _dense(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Linear layer in x's dtype, rounding the product before the bias add
    as the JAX package's ``nn.Dense`` does."""
    w = layer.weight.reshape(layer.weight.shape[0], -1)
    y = torch.matmul(x, w.to(x.dtype).t())
    return y if layer.bias is None else y + layer.bias.to(x.dtype)


def _flax_layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm`` numerics: f32 statistics with the fast variance
    E[x²] − E[x]² (clipped at 0), ``norm.eps``, result in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(torch.float32)
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
    3-D relative-position bias table with its index buffer (v5's with the
    extra token). With ``shards`` > 1, one rank's ``num_heads`` of a
    tensor-parallel model: qkv's output and proj's input are those heads'
    (``parallel.mesh.shard_params``)."""

    def __init__(self, dim: int, num_heads: int, cube: tuple[int, int, int],
                 extra_token: bool = False, shards: int = 1):
        super().__init__()
        idx, table = bias_index(cube, extra_token)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim // shards)
        self.proj = nn.Linear(dim // shards, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((table, num_heads)))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(idx.astype(np.int64)))

    def bias(self) -> torch.Tensor:
        """(H, N, N) attention bias gathered from the table. ``index_select``
        and not ``table[idx]``: its gradient (``index_add_``) sums the
        repeated indices in a fixed order on the CPU, where advanced
        indexing's accumulates in parallel and varies in the last bit."""
        n = self.relative_position_index.shape[0]
        idx = self.relative_position_index.reshape(-1)
        return torch.index_select(self.relative_position_bias_table, 0,
                                  idx).reshape(
            n, n, self.num_heads
        ).permute(2, 0, 1)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


@dataclasses.dataclass
class _SliceDraws:
    """Dropout draws for a tensor that holds the slice [lo, hi) of ``axis``
    of the whole model's (a tensor-parallel rank's heads or hidden units):
    each draw is the whole tensor's, from ``generator`` (a torch.Generator
    or a ``BatchShard``), cut to the slice, so the ranks draw the
    replicated model's masks in its order."""

    generator: object
    axis: int
    full: int
    lo: int
    hi: int

    def rand(self, shape) -> torch.Tensor:
        shape = list(shape)
        shape[self.axis] = self.full
        u = _uniform(tuple(shape), self.generator,
                     getattr(self.generator, "device", None))
        return u.narrow(self.axis, self.lo, self.hi - self.lo)


class CrossScaleBlock(nn.Module):
    """Pre-LN attention + MLP block. On the block kernels its parameters
    travel as the 13-tuple of ``fused_params`` (the w8a8 ones as
    ``quant_params``) and ``forward`` is the single-block dispatch point
    (K2, or K4 when quantized, on CUDA); off them ``forward`` runs
    ``unfused``. With ``tp`` (a mesh whose model axis is above 1), one
    rank's part of a tensor-parallel block (module docstring), always
    unfused."""

    def __init__(self, cfg: ModelConfig, cube: tuple[int, int, int],
                 extra_token: bool = False, drop_path: float = 0.0,
                 tp: Optional[Mesh] = None):
        super().__init__()
        dim = cfg.embed_dim
        hidden = int(dim * cfg.mlp_ratio)
        n = tp.shape["model"] if tp is not None else 1
        self.tp = tp
        self.num_heads = cfg.num_heads // n
        self.exact_gelu = cfg.exact_gelu
        self.fused_attention = cfg.fused_attention
        self.drop, self.attn_drop = cfg.drop_ratio, cfg.attn_drop_ratio
        self.drop_path = drop_path
        self.kernel_eligible = (
            cfg.fused_block and cfg.fused_attention and not cfg.exact_gelu
            and self.drop == 0.0 and self.attn_drop == 0.0
            and drop_path == 0.0 and tp is None
        )
        # as in the JAX package, quantization rides the block kernels only
        self.quantize = cfg.quantize if self.kernel_eligible else ""
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, self.num_heads, cube, extra_token, n)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden // n)
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

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                calibrate: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One block. ``calibrate`` (``w8a8-static``) runs the plain
        calibration forward instead and folds its abs-maxes into
        ``act_amax``; ``train`` runs the training forward (on the block
        kernel that is ``fused_block`` under autograd: no dropout to
        draw)."""
        if not self.kernel_eligible:
            return self.unfused(x, dtype, train, generator)
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
                              exact_gelu=exact,
                              quant_attn=self.quantize.endswith("+attn"))

    def unfused(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The JAX package's block off the block kernel
        (``CrossScaleBlock.__call__``): flax-numerics LayerNorm, every dense
        in ``dtype`` from the parameters, the attention through K7 (K6 in
        training; with ``fused_attention`` off or attention dropout in
        training, K8's plain version ``attention_bnhd_ref``, the JAX
        package's ``CrossScaleAttention`` off its kernels), the projection,
        LayerNorm, the GELU MLP and the residuals, with dropout and drop
        path in training."""
        g = generator
        drop = (lambda t: dropout(t, self.drop, g)) if train else (lambda t: t)
        dpath = ((lambda t: drop_path(t, self.drop_path, g)) if train
                 else (lambda t: t))
        x = x.to(dtype)
        bias, heads = self.attn.bias(), self.num_heads
        qkv = _dense(self._into_shard(_flax_layer_norm(x, self.norm1)),
                     self.attn.qkv)
        if not self.fused_attention or (train and self.attn_drop):
            a = attention_bnhd_ref(*split_qkv(qkv, heads), bias,
                                   self.attn_drop if train else 0.0,
                                   self._slice_draws(g, 1, heads))
            a = a.reshape(qkv.shape[0], qkv.shape[1], -1)
        elif train:
            a = fused_attention_train(qkv, bias, heads)
        else:
            a = fused_attention_qkv(qkv, bias, heads)
        x = x + dpath(drop(self._out_of_shard(a, self.attn.proj)))
        y = gelu(_dense(self._into_shard(_flax_layer_norm(x, self.norm2)),
                        self.mlp.fc1), exact=self.exact_gelu)
        if train:
            y = dropout(y, self.drop,
                        self._slice_draws(g, 2, self.mlp.fc1.out_features))
        return x + dpath(drop(self._out_of_shard(y, self.mlp.fc2)))

    def _into_shard(self, h: torch.Tensor) -> torch.Tensor:
        """The input of a sliced product: under TP through Megatron's f."""
        return h if self.tp is None else copy_to_model(h, self.tp)

    def _out_of_shard(self, a: torch.Tensor, layer: nn.Linear
                      ) -> torch.Tensor:
        """``_dense(a, layer)``; under TP the float32 partial product, its
        SUM over the model axis (Megatron's g) rounded to a's dtype as one
        product would be, then the whole bias."""
        if self.tp is None:
            return _dense(a, layer)
        f32 = torch.float32
        part = torch.matmul(a.to(f32), layer.weight.to(a.dtype).to(f32).t())
        y = reduce_from_model(part, self.tp).to(a.dtype)
        return y + layer.bias.to(a.dtype)

    def _slice_draws(self, generator, axis: int, local: int):
        """Dropout draws for this rank's ``local`` entries of ``axis`` (its
        heads, or its hidden units): the generator itself off TP."""
        if self.tp is None or generator is None:
            return generator
        m = self.tp.coords["model"]
        return _SliceDraws(generator, axis, local * self.tp.shape["model"],
                           m * local, (m + 1) * local)


class AuxBlock(nn.Module):
    """Deep-supervision head of v4 and v5 (the JAX package's ``AuxBlock``),
    training only. Per scale: the token grid → 2×2 VALID convolution (no
    bias) → BatchNorm → ReLU → Dropout2d → 1×1 convolution to dim/n_scales
    → mean over the grid; the scales concatenated (v5: with the extra
    token), LayerNorm (v4 only: v5 constructs it and never calls it), the
    output projection. One convolution, BatchNorm and dropout serve every
    scale; the BatchNorm's running statistics move once per scale.
    ``aux`` is the reference's ``nn.Sequential``, kept for its names
    (``aux.0``, ``aux.1``, ``aux.4``); ``forward`` computes explicitly."""

    def __init__(self, dim: int, out_dim: int, cube: tuple[int, int, int],
                 extra_token: bool = False, drop: float = 0.3):
        super().__init__()
        c = cube[0]
        self.cube = cube
        self.extra_token = extra_token
        self.aux = nn.Sequential(
            nn.Conv2d(dim, dim, 2, bias=False),
            nn.BatchNorm2d(dim),
            nn.ReLU(), nn.Dropout2d(drop), nn.Conv2d(dim, dim // c, 1))
        width = c * (dim // c)
        self.norm = nn.LayerNorm(2 * dim if extra_token else width,
                                 eps=LN_EPS)
        self.out_features = nn.Linear(width + (dim if extra_token else 0),
                                      out_dim)

    def _batch_norm(self, x: torch.Tensor,
                    shard: Optional[BatchShard] = None) -> torch.Tensor:
        """flax ``nn.BatchNorm`` in training on NHWC: float32 batch
        statistics over (B, H, W) with the biased fast variance E[x²] −
        E[x]² (clipped at 0), the running buffers moved to momentum·running
        + (1 − momentum)·batch in place, the result in x's dtype. With a
        ``shard``, x holds this rank's rows and the moments are those of the
        global batch: the sums travel through a differentiable
        ``all_reduce``, as GSPMD's global program reduces them."""
        bn = self.aux[1]
        xf = x.to(torch.float32)
        if shard is None:
            mu = xf.mean(dim=(0, 1, 2))
            ex2 = (xf * xf).mean(dim=(0, 1, 2))
        else:
            sums = all_reduce_sum(torch.stack(
                [xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))]),
                shard.mesh)
            mu, ex2 = sums / float(shard.batch * x.shape[1] * x.shape[2])
        var = torch.clamp(ex2 - mu * mu, min=0.0)
        with torch.no_grad():
            for buf, stat in ((bn.running_mean, mu), (bn.running_var, var)):
                buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * stat)
        mul = torch.rsqrt(var + BN_EPS) * bn.weight.to(torch.float32)
        return ((xf - mu) * mul + bn.bias.to(torch.float32)).to(x.dtype)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, h, w = self.cube
        conv1, _, _, drop, conv2 = self.aux
        shard = generator if isinstance(generator, BatchShard) else None
        b, d = x.shape[0], x.shape[-1]
        # the 2×2 VALID convolution as one product over the four shifted
        # grids, (row, col, channel) ordered as the kernel flattens
        k1 = conv1.weight.permute(0, 2, 3, 1).reshape(d, 4 * d).to(x.dtype)
        parts = []
        for i in range(c):
            xi = x[:, h * w * i : h * w * (i + 1)].reshape(b, h, w, d)
            xi = torch.cat([xi[:, r : r + h - 1, s : s + w - 1]
                            for r in (0, 1) for s in (0, 1)], dim=-1)
            xi = torch.relu(self._batch_norm(torch.matmul(xi, k1.t()),
                                             shard))
            xi = dropout(xi, drop.p, generator, shape=(b, 1, 1, d))
            parts.append(_dense(xi, conv2).mean(dim=(1, 2)))
        y = torch.cat(parts, dim=-1)
        if self.extra_token:
            y = torch.cat([y, x[:, h * w * c :].reshape(b, -1)], dim=-1)
        else:
            y = _flax_layer_norm(y, self.norm)
        return _dense(y, self.out_features)


def _pool2x2_per_scale(x: torch.Tensor, n_scales: int, grid: int):
    """Per-scale 2×2 average pooling of the token cube,
    (B, n·g² [+1], D) → (B, n·(g/2)² [+1], D); a trailing extra token (v5)
    passes through."""
    b, _, d = x.shape
    g = grid
    cube = x[:, : n_scales * g * g].reshape(
        b, n_scales, g // 2, 2, g // 2, 2, d).mean(dim=(3, 5))
    return torch.cat([cube.reshape(b, n_scales * (g // 2) ** 2, d),
                      x[:, n_scales * g * g :]], dim=1)


def _mean_pool_scales(x: torch.Tensor, n_scales: int, tokens: int):
    """Mean of each scale's ``tokens`` tokens: (B, ·, D) → (B, n·D)."""
    b, _, d = x.shape
    core = x[:, : n_scales * tokens].reshape(b, n_scales, tokens, d)
    return core.mean(dim=2).reshape(b, n_scales * d)


class S2Former(nn.Module):
    """The S2Former family: ``forward(patches, designed)`` → (B, out_dim);
    in training v4 and v5 return ``(out, aux0, aux1)``. With ``mesh`` (a
    model axis above 1), this rank's part of the tensor-parallel model
    (module docstring); load it with ``parallel.mesh.shard_params``."""

    def __init__(self, cfg: ModelConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        check_supported(cfg)
        if cfg.variant == "vit":
            raise ValueError("variant 'vit' is the ScaleEmbedTransformer, not "
                             "an S2Former: build it with build_model")
        tp = mesh if mesh is not None and mesh.shape["model"] > 1 else None
        if tp is not None:
            check_tensor_parallel(cfg, tp.shape["model"])
        self.cfg = cfg
        v, n, g, dim = cfg.variant, cfg.n_scales, cfg.cube, cfg.embed_dim
        self.dtype = getattr(torch, cfg.dtype)
        self.calibrating = False
        self.act_amax_calibrated = False
        if v != "v6":
            embeds = [PatchEmbed(cfg.in_channels, s // g, dim)
                      for s in cfg.input_image_scales]
            if v == "v1":
                for i, pe in enumerate(embeds):
                    self.add_module(f"patch_embed_scale{i}", pe)
            else:
                self.patch_embed_blocks = nn.ModuleList(embeds)
        if cfg.use_designed_features or v in ("v5", "v6"):
            self.feature_embed = FeatureEmbed(cfg.designed_feature_dim, dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        if v == "v6":
            self.final_features_with_design = nn.Linear(dim, cfg.out_dim)
            self._add_head()
            return
        extra = v == "v5"

        def stage(depth, grid, drop_paths=None):
            return nn.ModuleList(
                CrossScaleBlock(cfg, (n, grid, grid), extra,
                                float(drop_paths[i]) if drop_paths is not None
                                else 0.0, tp)
                for i in range(depth))

        if v in ("v1", "v2"):
            dpr = (np.linspace(0, cfg.drop_path_ratio, cfg.depth[0])
                   if v == "v1" else None)
            self.blocks = stage(cfg.depth[0], g, dpr)
        else:
            self.blocks0 = stage(cfg.depth[0], g)
            self.blocks1 = stage(cfg.depth[1], g // 2)
            self.blocks2 = stage(cfg.depth[2], g // 4)
        # the reference constructs both output projections whatever the
        # configuration (the one never called is 100-wide and exports as
        # zeros)
        designed = cfg.use_designed_features
        self.final_features = nn.Linear(
            n * dim, 100 if designed or extra else cfg.out_dim)
        if extra:
            self.last_block_features = nn.Linear((n + 1) * dim, dim)
            self.final_features_with_design = nn.Linear(2 * dim, cfg.out_dim)
        else:
            self.final_features_with_design = nn.Linear(
                (n + 1) * dim, cfg.out_dim if designed else 100)
        self._add_head()
        if v in ("v4", "v5"):
            self.aux0 = AuxBlock(dim, cfg.out_dim, (n, g, g), extra)
            self.aux1 = AuxBlock(dim, cfg.out_dim, (n, g // 2, g // 2), extra)

    def _add_head(self) -> None:
        if self.cfg.num_classes > 0:  # the reference's class head, unused
            self.head = nn.Linear(self.cfg.out_dim, self.cfg.num_classes)

    def _patch_embeds(self) -> list:
        if self.cfg.variant == "v1":
            return [getattr(self, f"patch_embed_scale{i}")
                    for i in range(self.cfg.n_scales)]
        return list(self.patch_embed_blocks)

    def _designed(self, designed: torch.Tensor) -> torch.Tensor:
        """The designed-feature token: FeatureEmbed, then the shared
        LayerNorm."""
        return _flax_layer_norm(self.feature_embed(designed.to(self.dtype)),
                                self.norm)

    def _stage(self, blocks: nn.ModuleList, x: torch.Tensor, chain: bool,
               train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A stage as one chain launch when ``chain`` is on and it has more
        than one block on the block kernels, else block by block (always
        while calibrating, so that each block records its own abs-maxes,
        and in training)."""
        if not len(blocks):
            return x
        x = x.to(self.dtype)
        if (chain and len(blocks) > 1 and blocks[0].kernel_eligible
                and not train and not self.calibrating):
            kw = dict(heads=self.cfg.num_heads,
                      exact_gelu=self.cfg.exact_gelu)
            if blocks[0].quantize:
                return fused_block_chain_q8(
                    x, [blk.quant_params(self.dtype) for blk in blocks],
                    quant_attn=blocks[0].quantize.endswith("+attn"), **kw)
            return fused_block_chain(
                x, [blk.fused_params(self.dtype) for blk in blocks], **kw)
        for blk in blocks:
            x = blk(x, self.dtype, calibrate=self.calibrating, train=train,
                    generator=generator)
        return x

    def _static_blocks(self):
        return [b for b in self.modules()
                if isinstance(b, CrossScaleBlock) and b.quantize == STATIC]

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

    def forward(self, patches, designed=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Embeddings (B, out_dim); with ``train`` (the JAX package's
        ``train`` argument) the training forward, its masks drawn from
        ``generator``, returning ``(out, aux0, aux1)`` for v4 and v5."""
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
        v, n, g = cfg.variant, cfg.n_scales, cfg.cube
        if v == "v6":
            return _dense(self._designed(designed),
                          self.final_features_with_design)
        x = torch.cat([pe(p.to(self.dtype))
                       for pe, p in zip(self._patch_embeds(), patches)], dim=1)
        if train:
            x = dropout(x, cfg.drop_ratio, generator)
        stage = lambda blocks, x, chain: self._stage(blocks, x, chain, train,
                                                     generator)
        if v in ("v1", "v2"):
            x = _flax_layer_norm(stage(self.blocks, x, False), self.norm)
            pooled = _mean_pool_scales(x, n, g * g)
            if cfg.use_designed_features:
                return _dense(torch.cat([pooled, self._designed(designed)],
                                        dim=-1),
                              self.final_features_with_design)
            return _dense(pooled, self.final_features)

        if v == "v5":
            d = self._designed(designed)
            x = torch.cat([x, d[:, None, :]], dim=1)
        aux = v in ("v4", "v5") and train
        chain = cfg.fused_stage_chain
        # stage 0 runs block by block (chain_stage0 is not supported)
        x = stage(self.blocks0, x, False)
        aux0 = self.aux0(x, generator) if aux else None
        x = _flax_layer_norm(_pool2x2_per_scale(x, n, g), self.norm)
        x = stage(self.blocks1, x, chain)
        aux1 = self.aux1(x, generator) if aux else None
        x = _flax_layer_norm(_pool2x2_per_scale(x, n, g // 2), self.norm)
        x = _flax_layer_norm(stage(self.blocks2, x, chain), self.norm)
        g2 = (g // 4) ** 2
        pooled = _mean_pool_scales(x, n, g2)
        if v == "v5":
            feats = _dense(torch.cat([pooled, x[:, n * g2 :].mean(dim=1)],
                                     dim=-1), self.last_block_features)
            out = _dense(torch.cat([feats, d], dim=-1),
                         self.final_features_with_design)
        elif cfg.use_designed_features:
            out = _dense(torch.cat([pooled, self._designed(designed)], dim=-1),
                         self.final_features_with_design)
        else:
            out = _dense(pooled, self.final_features)
        return (out, aux0, aux1) if aux else out

    def classify(self, embedding: torch.Tensor) -> torch.Tensor:
        """The optional class head over the embedding (the reference's
        ``head``)."""
        return _dense(embedding, self.head)


def build_model(cfg: ModelConfig, mesh: Optional[Mesh] = None
                ) -> nn.Module:
    """The backbone of ``cfg``, the one place the port builds a model:
    S2Former v1–v6, or the ScaleEmbedTransformer through its pipeline
    adapter (``models/vit.ScaleEmbedBackbone``) for ``variant="vit"``.
    With ``mesh``, this rank's part of the tensor-parallel S2Former when
    its model axis is above 1. Raises ``ValueError`` as the JAX package's
    ``build_model`` does, and for what tensor parallelism does not take."""
    check_supported(cfg)
    if cfg.variant == "vit":
        if mesh is not None and mesh.shape["model"] > 1:
            raise ValueError("tensor parallelism (a model axis above 1) "
                             "splits S2Former blocks only, not the vit")
        from deepmerge_tpu_torch.models.vit import ScaleEmbedBackbone

        return ScaleEmbedBackbone(cfg)
    return S2Former(cfg, mesh)
