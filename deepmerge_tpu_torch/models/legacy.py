"""Legacy model families in PyTorch (port of ``deepmerge_tpu/models/legacy.py``;
reference ``Nets.py``, ``MLP.py``, ``Networks.py``).

  * ``MLP`` — 784→250→250→10 leaky-ReLU net returning (logits, penultimate)
    (``Nets.py:11-35``).
  * ``GRUAttention`` — 4-layer bidirectional GRU(h=80) + dot-product
    attention pooling + Linear(160→10) (``Nets.py:48-111``). The GRU is
    ``nn.GRU``: the directions concatenated per layer, the backward one in
    the input's order, no inter-layer dropout, as the JAX package's
    ``nn.RNN(reverse=True, keep_order=True)`` pairs. flax's ``GRUCell`` has
    no hidden bias on the r and z gates, so those parts of ``bias_hh`` stay
    zero: their gradients are masked.
  * ``SpatiallyMemorizedNetwork`` — VGG16 features + embedded-Gaussian
    non-local block + GAP + L2-norm, with attention pooling over the three
    context embeddings (``Networks.py:17-174``; the non-local block is the
    standard one the reference's missing ``Non_local_block`` import
    intended).

The image nets take NHWC input, as the JAX package's (the triplet sampler's
patches), and convolve in NCHW, PyTorch's layout; ``leaky_relu``'s slope is
0.01 as in flax. Parameters stay float32 and each op runs in the compute
dtype. Dropout draws from the ``generator`` passed with ``train=True``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepmerge_tpu_torch.ops.dropout import dropout


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                    padding=layer.padding)


class MLP(nn.Module):
    """``Nets.py:11-35``: returns (logits, penultimate)."""

    def __init__(self, in_dim: int = 784, hidden: int = 250,
                 num_classes: int = 10):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.fc3 = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor):
        h1 = F.leaky_relu(self.fc1(x))
        h2 = F.leaky_relu(self.fc2(h1))
        return F.leaky_relu(self.fc3(h2)), h2


def dot_attention_pool(x: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """``attention_net`` (``Nets.py:75-93``): softmax(q·xᵀ/√d)·x summed over
    the queries."""
    scores = torch.matmul(query, x.transpose(1, 2)) / math.sqrt(
        float(query.shape[-1]))
    return torch.matmul(torch.softmax(scores, dim=-1), x).sum(dim=1)


class GRUAttention(nn.Module):
    """``Nets.py:48-111``: 4-layer bi-GRU + attention pooling + classifier,
    over (B, T, F) rows."""

    def __init__(self, in_dim: int = 28, hidden: int = 80,
                 num_layers: int = 4, num_classes: int = 10,
                 drop: float = 0.5):
        super().__init__()
        self.drop = drop
        self.rnn = nn.GRU(in_dim, hidden, num_layers=num_layers,
                          batch_first=True, bidirectional=True)
        self.out = nn.Linear(2 * hidden, num_classes)
        mask = torch.ones(3 * hidden)
        mask[: 2 * hidden] = 0.0  # flax's r and z gates: no hidden bias
        for name, p in self.rnn.named_parameters():
            if name.startswith("bias_hh"):
                with torch.no_grad():
                    p.mul_(mask)
                p.register_hook(lambda g, m=mask: g * m.to(g.device, g.dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, _ = self.rnn(x)
        query = dropout(h, self.drop, generator) if train else h
        return self.out(dot_attention_pool(h, query))


class NonLocalBlock2D(nn.Module):
    """Embedded-Gaussian non-local block on NCHW (the reference's missing
    ``Non_local_block``, ``Networks.py:13``); ``w_z`` starts at zero, so a
    fresh block is the identity."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 2, 1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.w_z = nn.Conv2d(inter, channels, 1)
        nn.init.zeros_(self.w_z.weight)
        nn.init.zeros_(self.w_z.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = lambda t: t.reshape(b, t.shape[1], h * w).transpose(1, 2)
        theta, phi, g = (flat(_conv(x, m)) for m in (self.theta, self.phi,
                                                     self.g))
        logits = torch.matmul(theta.to(torch.float32),
                              phi.to(torch.float32).transpose(1, 2))
        attn = torch.softmax(logits, dim=-1).to(x.dtype)
        y = torch.matmul(attn, g).transpose(1, 2).reshape(b, -1, h, w)
        return x + _conv(y, self.w_z)


VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG16Features(nn.Module):
    """VGG16's 13 3×3 convolutions (``conv0``..``conv12``) with ReLU and
    five 2×2 max pools, NCHW."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        c, i = in_channels, 0
        for v in VGG16_CFG:
            if v != "M":
                self.add_module(f"conv{i}", nn.Conv2d(c, v, 3, padding=1))
                c, i = v, i + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for v in VGG16_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = torch.relu(_conv(x, getattr(self, f"conv{i}")))
                i += 1
        return x


class SpatiallyMemorizedNetwork(nn.Module):
    """``Networks.py:17-174`` (class name de-typo'd from
    ``SpatiallyMmemorizedNetwork``): per-context L2-normalized VGG +
    non-local embedding of (B, H, W, C) crops; ``pool_contexts`` applies the
    attention pooling over the (inner, object, scene) context embeddings
    (``:119-146``)."""

    def __init__(self, out_channels: int = 512, reduced_size: int = 512,
                 drop: float = 0.5, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop, self.dtype = drop, dtype
        self.vgg16 = VGG16Features(in_channels)
        # the JAX package's name, a Python keyword
        self.add_module("nonlocal", NonLocalBlock2D(512))
        if reduced_size < out_channels:
            self.reduce = nn.Linear(512, reduced_size)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = getattr(self, "nonlocal")(self.vgg16(x)).mean(dim=(2, 3))  # GAP
        if hasattr(self, "reduce"):
            x = _linear(x, self.reduce)
        return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-6)

    def pool_contexts(self, embeddings: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """(B, 3, D) context embeddings → (B, D) attention-pooled."""
        query = (dropout(embeddings, self.drop, generator) if train
                 else embeddings)
        return dot_attention_pool(embeddings, query)
