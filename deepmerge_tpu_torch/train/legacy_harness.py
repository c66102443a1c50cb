"""Legacy classification harness in PyTorch (port of
``deepmerge_tpu/train/legacy_harness.py``; reference ``MLP.py:21-304``).

The reference's MNIST-style playground: train the MLP (or the bi-GRU
attention net) on flat digit-like vectors, save penultimate features to a
resizable HDF5 dataset and reload them (``MLP.py`` h5py save/load — here
``infer/extract.FeatureStore``). The synthetic-digits default removes the
torchvision download. Adam has optax's defaults (b1 0.9, b2 0.999, eps
1e-8). Both trainers run on the card unless the caller asks for the CPU.
The GRU's dropout masks come from a ``torch.Generator`` and cannot match
the JAX package's stream: its run is held by its accuracy, not step by
step.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepmerge_tpu_torch.infer.extract import FeatureStore
from deepmerge_tpu_torch.models.legacy import MLP, GRUAttention
from deepmerge_tpu_torch.utils.device import resolve_device


def synthetic_digits(n: int = 2048, side: int = 28, n_classes: int = 10,
                     seed: int = 0):
    """Digit-like (x, y): one bright square per class position + noise."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, n)
    x = rng.rand(n, side, side).astype(np.float32) * 0.2
    for i in range(n):
        c = y[i]
        r0, c0 = 2 + (c // 5) * 10, 2 + (c % 5) * 5
        x[i, r0 : r0 + 6, c0 : c0 + 4] += 0.8
    return x, y.astype(np.int32)


def _adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _epochs(model, x, y, epochs, batch_size, lr, seed, loss_of, name,
            log_fn) -> list[float]:
    """Adam over shuffled full batches (the JAX package's order: one
    ``RandomState(seed)`` permutation an epoch, the remainder dropped);
    returns the mean loss of each epoch."""
    opt = _adam(model, lr)
    rng = np.random.RandomState(seed)
    n = len(x)
    means = []
    for epoch in range(epochs):
        perm = rng.permutation(n)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            take = torch.from_numpy(perm[i : i + batch_size]).to(x.device)
            loss = loss_of(x[take], y[take])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        means.append(float(torch.stack(losses).mean()))
        log_fn(f"{name} epoch {epoch + 1}/{epochs}: loss={means[-1]:.4f}")
    return means


def _accuracy(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((logits.argmax(1) == y).float().mean())


def train_mlp(
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    epochs: int = 3,
    batch_size: int = 128,
    lr: float = 1e-3,
    feature_h5: Optional[str] = None,
    seed: int = 0,
    log_fn: Callable = print,
    device: torch.device | str = "cuda",
):
    """Train the MLP on ``device`` from PyTorch's initialization seeded by
    ``seed``; optionally dump the penultimate features to HDF5. Returns
    (model, final accuracy, per-epoch mean losses)."""
    dev = resolve_device(device)
    if x is None:
        x, y = synthetic_digits(seed=seed)
    x = torch.from_numpy(x.reshape(len(x), -1).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MLP(x.shape[1], num_classes=int(y.max()) + 1)
    model = model.to(dev)

    def loss_of(xb, yb):
        return F.cross_entropy(model(xb)[0], yb)

    losses = _epochs(model, x, y, epochs, batch_size, lr, seed, loss_of,
                     "mlp", log_fn)
    with torch.no_grad():
        logits, feats = model(x)
    acc = _accuracy(logits, y)
    log_fn(f"train accuracy: {acc:.3f}")
    if feature_h5:
        store = FeatureStore(feature_h5)
        store.append(feats.cpu().numpy().astype(np.float32))
        store.close()
    return model, acc, losses


def train_gru(
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    epochs: int = 2,
    batch_size: int = 128,
    lr: float = 1e-3,
    seed: int = 0,
    log_fn: Callable = print,
    device: torch.device | str = "cuda",
):
    """Train the bi-GRU attention classifier on (B, T, F) rows on
    ``device``, the attention query's Dropout(0.5) drawn from a generator
    seeded by (``seed`` + 1, step) (``Nets.py:48-111``). Returns (model,
    final accuracy, per-epoch mean losses)."""
    dev = resolve_device(device)
    if x is None:
        x, y = synthetic_digits(n=1024, seed=seed)
    x = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(y, np.int64)).to(dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = GRUAttention(x.shape[-1], num_classes=int(y.max()) + 1)
    model = model.to(dev)
    gen = torch.Generator(device=dev)
    step = [0]

    def loss_of(xb, yb):
        gen.manual_seed((seed + 1) * 1_000_003 + step[0])
        step[0] += 1
        return F.cross_entropy(model(xb, True, gen), yb)

    losses = _epochs(model, x, y, epochs, batch_size, lr, seed, loss_of,
                     "gru", log_fn)
    with torch.no_grad():
        acc = _accuracy(model(x), y)
    log_fn(f"train accuracy: {acc:.3f}")
    return model, acc, losses
