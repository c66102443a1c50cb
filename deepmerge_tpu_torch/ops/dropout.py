"""Dropout and drop path in training, their masks drawn from an explicit
``torch.Generator`` (the JAX package's ``fold_in`` streams cannot be
reproduced in torch). A rate of 0 returns the input itself and draws
nothing. A ``parallel.mesh.BatchShard`` in place of the generator draws
the global batch's mask and keeps this rank's rows."""

from __future__ import annotations

from typing import Optional

import torch


def _uniform(shape, generator, device) -> torch.Tensor:
    if hasattr(generator, "rand"):  # a parallel.mesh.BatchShard
        return generator.rand(shape)
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shape: Optional[tuple] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: each entry kept with probability
    1 − rate and divided by it, else 0; with ``shape`` one draw per entry
    of that broadcastable shape (Dropout2d: (B, 1, 1, C) over NHWC)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _uniform(shape or x.shape, generator, x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """The JAX package's ``DropPath`` in training: whole samples dropped
    with probability ``rate``, the kept ones divided by 1 − rate."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = _uniform(shape, generator, x.device) < keep
    return x * mask.to(x.dtype) / keep
