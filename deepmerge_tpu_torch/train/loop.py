"""Training loop (port of ``deepmerge_tpu/train/loop.py``; reference
``Train_SMT.py:143-394``).

* The Siamese forward is ONE batched forward over the stacked
  [left; right] pairs (2B on the batch axis), split afterwards.
* Adam(1e-4) with a piecewise-constant decay ×0.2 at epochs [40, 80]
  (``Train_SMT.py:192-194``): ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps
  1e-8, the update of ``optax.adam``) with its learning rate set before
  every step from ``lr_schedule``, which gives optax's
  ``piecewise_constant_schedule`` values in float32.
* The model is ``training_model(cfg)``: every block unfused, its attention
  through the saved-probs kernel K6. Parameters stay float32; the forward
  casts them to ``model.dtype`` op by op. v4 and v5 add their aux heads'
  contrastive losses at ``train.aux_weights`` (``Train_SMT.py:285-288``),
  and their BatchNorm running statistics move in every step's forward.
* Dropout, drop path and the aux heads' Dropout2d draw from the state's
  ``torch.Generator`` on the training device, reseeded before every step
  from ``train.seed`` and the update count (the JAX package folds the step
  into its key): the masks of a step are a function of (seed, step), also
  after a resume, and drawing them needs no host synchronisation.
* The JAX package's scanned epoch (``lax.scan`` over the steps) is a
  Python loop over the steps with no host synchronisation inside: the
  patches are extracted on the device in every step, the losses stay on
  the device and are stacked at the end of the epoch.

The state is mutable, unlike the JAX package's: every step updates the
model's parameters and the optimizer's moments in place, and the step
functions return the same ``TrainState``.

Data parallelism (``make_train_step(cfg, mesh)``) does by hand what GSPMD's
global program does: each rank takes its rows of the batch
(``parallel.mesh.shard_rows``), scales its loss by 1 / n_data so that the
``all_reduce`` SUM of the ranks' gradients is the gradient of the whole
batch's mean loss, and takes the same Adam step. Its forward gets a
``parallel.mesh.BatchShard``: dropout masks drawn for the global batch and
cut to its rows, and v4/v5 BatchNorm moments summed over the ranks.

Tensor parallelism (a mesh whose model axis is above 1, and the model of
``create_train_state(cfg, ..., mesh=mesh)``): each rank holds its slices of
the blocks (``parallel.mesh.shard_params``) and the ranks of a model group
take the same rows. The gradients are summed over the data group only:
sliced parameters keep their own, and the replicated ones come out equal
on the ranks of a model group, because Megatron's f has summed the
activations' gradients in the backward. Adam is unchanged.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from deepmerge_tpu_torch.config import Config
from deepmerge_tpu_torch.models.s2former import build_model, training_model
from deepmerge_tpu_torch.ops.patches import extract_multiscale_patches
from deepmerge_tpu_torch.parallel.mesh import (
    BatchShard,
    Mesh,
    all_reduce_,
    shard_params,
)
from deepmerge_tpu_torch.train.losses import contrastive_pair_loss
from deepmerge_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    """The model, its Adam optimizer, the number of updates taken, the
    learning-rate schedule over that count, and the generator of the
    dropout masks (reseeded every step from ``seed`` and the count)."""

    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int
    lr: Callable[[int], float]
    generator: torch.Generator
    seed: int = 0

    def step_generator(self) -> torch.Generator:
        """The generator, reseeded for the step about to be taken."""
        return self.generator.manual_seed(self.seed * 1_000_003 + self.step)


def lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """MultiStepLR(milestones=[40, 80], gamma=0.2) as optax's
    ``piecewise_constant_schedule``: the value at update ``count`` is
    ``lr`` times ``gamma`` for every boundary ``m · steps_per_epoch <=
    count``, multiplied in float32 as optax multiplies."""
    t = cfg.train
    bounds = sorted(m * steps_per_epoch for m in t.lr_milestones)
    gamma = np.float32(t.lr_gamma)

    def schedule(count: int) -> float:
        v = np.float32(t.lr)
        for b in bounds:
            if count >= b:
                v = np.float32(gamma * v)
        return float(v)

    return schedule


def create_train_state(cfg: Config, steps_per_epoch: int = 1,
                       state_dict: Optional[dict] = None,
                       device: torch.device | str = "cuda",
                       mesh: Optional[Mesh] = None) -> TrainState:
    """The training model on ``device`` (the card unless the caller asks
    for the CPU; without a card that raises) with ``state_dict`` (the
    reference-named weights and, for v4 and v5, BatchNorm buffers; default
    ``init_state_dict`` from ``cfg.train.seed``), a fresh Adam, step 0.
    With ``mesh`` and a model axis above 1, this rank's part of the
    tensor-parallel model, loaded with its ``shard_params`` of the
    weights."""
    from deepmerge_tpu_torch.compat.weights import init_state_dict

    device = resolve_device(device)
    mcfg = training_model(cfg)
    model = build_model(mcfg, mesh)
    if state_dict is None:
        state_dict = init_state_dict(mcfg, seed=cfg.train.seed)
    if mesh is not None:
        state_dict = shard_params(state_dict, mesh)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(device)
    schedule = lr_schedule(cfg, steps_per_epoch)
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=optimizer, step=0, lr=schedule,
                      generator=torch.Generator(device=device),
                      seed=cfg.train.seed)


def _step_draws(state: TrainState, mesh: Optional[Mesh], pairs: int):
    """The step's generator and the loss scale; with a mesh, a
    ``BatchShard`` of this rank's ``pairs`` rows of the global [left;
    right] batch and the scale 1 / n_data."""
    gen = state.step_generator()
    if mesh is None:
        return gen, 1.0
    n = mesh.shape["data"]
    own = torch.arange(pairs) + mesh.coords["data"] * pairs
    rows = torch.cat([own, own + n * pairs])
    return BatchShard(gen, rows, 2 * n * pairs, mesh), 1.0 / n


def _siamese_loss(state: TrainState, cfg: Config, patches, designed, flag,
                  mesh: Optional[Mesh] = None):
    """The training forward of the stacked [left; right] batch and the
    contrastive loss of its halves, plus ``train.aux_weights`` times the
    aux heads' (v4, v5) losses where the weight is positive. With a mesh,
    this rank's part of the global batch's loss."""
    margin = cfg.train.margin
    draws, scale = _step_draws(state, mesh, flag.shape[0])
    out = state.model(patches, designed, train=True, generator=draws)
    emb, *aux = out if isinstance(out, tuple) else (out,)
    loss = contrastive_pair_loss(*torch.chunk(emb, 2, dim=0), flag, margin)
    for a, w in zip(aux, cfg.train.aux_weights):
        if w > 0.0:
            loss = loss + w * contrastive_pair_loss(
                *torch.chunk(a, 2, dim=0), flag, margin)
    return loss * scale if mesh is not None else loss


def apply_gradients(state: TrainState, loss: torch.Tensor,
                    mesh: Optional[Mesh] = None) -> TrainState:
    """Backward of ``loss`` and one Adam update at the learning rate of the
    current step count; with a mesh, the gradients are summed over its data
    axis first (one ``all_reduce`` of them all, flattened)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr(state.step)
    state.optimizer.step()
    state.step += 1
    return state


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None):
    """The Siamese train step on a host-materialized batch; with ``mesh``,
    on this rank's rows of it (``PairSampler.epoch_batches(rows=...)``),
    the loss in the metrics being the whole batch's on every rank.

    Batch dict:
      left_patches / right_patches: tuple of (B, s, s, C) per input scale
      left_designed / right_designed: (B, 19)
      flag: (B,) float — 1 same-object, 0 different (``MyUtils1.py:35-36``)

    ``train_step(state, batch) -> (state, {"loss": device scalar})``.
    """

    def train_step(state: TrainState, batch):
        patches = tuple(
            torch.cat([l, r], dim=0)
            for l, r in zip(batch["left_patches"], batch["right_patches"])
        )
        designed = torch.cat([batch["left_designed"],
                              batch["right_designed"]], dim=0)
        loss = _siamese_loss(state, cfg, patches, designed, batch["flag"],
                             mesh)
        state = apply_gradients(state, loss, mesh)
        loss = loss.detach()
        if mesh is not None:
            loss = all_reduce_(loss.clone(), mesh)
        return state, {"loss": loss}

    return train_step


def _extracting_loss(cfg: Config, device_scene):
    """Loss of one step whose patches are extracted on the device from the
    staged scene, inside the step (the fused step and the scanned epoch).
    The sampler checked every point against the scene, so the window gather
    runs without its bounds check's host sync."""
    patch_sizes = tuple(cfg.data.patch_sizes)
    quantize = cfg.data.quantize_uint8

    def loss_fn(state, centers, scales, designed, flag):
        with torch.no_grad():
            patches = extract_multiscale_patches(
                device_scene.padded, centers, scales,
                patch_sizes=patch_sizes, caps=device_scene.caps,
                quantize_uint8=quantize, out_channels=device_scene.channels,
                out_dtype=state.model.dtype, trusted_origins=True,
            )
        return _siamese_loss(state, cfg, patches, designed, flag)

    return loss_fn


def make_fused_train_step(cfg: Config, device_scene):
    """Siamese train step with the patch pipeline inside the step: the batch
    is per-pair point metadata (``FusedPairSampler.epoch_batches``) —
    window gather (K1), crop + INTER_AREA resize, the forward, loss and the
    update in one step."""
    loss_fn = _extracting_loss(cfg, device_scene)

    def train_step(state: TrainState, batch):
        loss = loss_fn(state, batch["centers"], batch["scales"],
                       batch["designed"], batch["flag"])
        return apply_gradients(state, loss), {"loss": loss.detach()}

    return train_step


def make_scanned_epoch(cfg: Config, device_scene):
    """An entire epoch of fused steps: ``epoch_fn(state, centers, scales,
    designed, flags) -> (state, losses)`` with the arrays of
    ``FusedPairSampler.epoch_arrays`` and ``losses`` a (steps,) float32
    device tensor. No host synchronisation inside the loop."""
    loss_fn = _extracting_loss(cfg, device_scene)

    def epoch_fn(state: TrainState, centers, scales, designed, flags):
        losses = []
        for c, s, d, f in zip(centers, scales, designed, flags):
            loss = loss_fn(state, c, s, d, f)
            state = apply_gradients(state, loss)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return epoch_fn


def make_eval_step(model: torch.nn.Module):
    """Single-branch embedding forward (the inference path)."""

    @torch.inference_mode()
    def eval_step(patches, designed):
        return model(patches, designed)

    return eval_step


def train_epoch(
    state: TrainState,
    train_step,
    batches,
    log_every: int = 0,
    log_fn=print,
) -> tuple[TrainState, float]:
    """Run one epoch over an iterable of batches; returns the mean loss.

    Losses stay on the device until the epoch ends (a per-step host sync
    would stall the dispatch pipeline), except at ``log_every``.
    """
    losses = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        state, metrics = train_step(state, batch)
        losses.append(metrics["loss"])
        if log_every and (i + 1) % log_every == 0:
            log_fn(
                f"  step {i + 1}: loss={float(metrics['loss']):.5f} "
                f"({(time.time() - t0) / (i + 1):.3f}s/step)"
            )
    if not losses:
        return state, 0.0
    return state, float(torch.stack(losses).float().mean())
