"""Top-level training driver (port of ``deepmerge_tpu/train/driver.py``;
reference ``Train_SMT.train``/``main``, ``Train_SMT.py:143-394``).

A device-resident scene, fresh per-epoch sampling seeds instead of dataset
rebuilds, checkpoints at the reference cadence, loss-history logging. One
scene trains through the scanned epoch (``make_scanned_epoch``: patches
extracted in every step with K1, the blocks' attention through K6); a list
of scenes through host-materialized batches. Any variant trains (v4 and v5
with their aux losses at ``train.aux_weights``). The sharded trainer
(``use_mesh``) is the port's scale-out item.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from deepmerge_tpu_torch.config import Config
from deepmerge_tpu_torch.geodata.synthetic import (
    generate_scene,
    make_training_pairs,
)
from deepmerge_tpu_torch.geodata.types import Scene
from deepmerge_tpu_torch.train.callbacks import LossHistory
from deepmerge_tpu_torch.train.checkpoint import (
    CheckpointManager,
    should_checkpoint,
)
from deepmerge_tpu_torch.train.loop import (
    create_train_state,
    make_scanned_epoch,
    make_train_step,
    train_epoch,
)
from deepmerge_tpu_torch.train.sampler import (
    FusedPairSampler,
    MultiScenePairSampler,
    PairSampler,
)


def _start_pull(losses: Optional[torch.Tensor]):
    """Start copying an epoch's device losses to the host. The copy is
    ordered after that epoch's steps only, so waiting for it (``resolve``)
    does not wait for the steps enqueued after it, as a plain ``.cpu()``
    later in the stream would. Returns (host tensor, event or None)."""
    if losses is None or losses.device.type != "cuda":
        return losses, None
    host = torch.empty(losses.shape, dtype=losses.dtype, pin_memory=True)
    host.copy_(losses, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def train(
    cfg: Config,
    scene: Optional[Scene | list[Scene]] = None,
    pos_pairs: Optional[np.ndarray] = None,
    neg_pairs: Optional[np.ndarray] = None,
    use_mesh: bool = False,
    max_steps_per_epoch: Optional[int] = None,
    log_fn=print,
    device: torch.device | str = "cuda",
):
    """Train the configured model on ``device``; returns (state, history).

    ``scene`` may be a list of Scenes (the reference trains over many tiles,
    ``MyUtils1.py:236-295``) — pairs are then sampled per scene and batches
    interleaved.
    """
    if use_mesh:
        raise NotImplementedError(
            "use_mesh: the sharded trainer (DDP with tensor-parallel "
            "linears) is the port's scale-out item (ROADMAP.md queue A, "
            "Scale-out)"
        )
    device = torch.device(device)
    if scene is None:
        scene = generate_scene(seed=cfg.train.seed)

    if isinstance(scene, list):
        if pos_pairs is not None or neg_pairs is not None:
            raise ValueError(
                "pos_pairs/neg_pairs are only supported with a single scene; "
                "multi-scene training samples pairs per scene"
            )
        sampler = MultiScenePairSampler([
            PairSampler(s, *make_training_pairs(s), cfg.data, device)
            for s in scene
        ])
    else:
        if pos_pairs is None or neg_pairs is None:
            pos_pairs, neg_pairs = make_training_pairs(scene)
        # single scene: the patch pipeline runs inside the train step
        sampler = FusedPairSampler(scene, pos_pairs, neg_pairs, cfg.data,
                                   device)
    steps_per_epoch = max(len(sampler) // cfg.data.batch_size, 1)
    state = create_train_state(cfg, steps_per_epoch, device=device)
    if isinstance(sampler, FusedPairSampler):
        epoch_fn = make_scanned_epoch(cfg, sampler.device_scene)
    else:
        epoch_fn, step_fn = None, make_train_step(cfg)

    ckpt = CheckpointManager(cfg.train.checkpoint_dir, cfg)
    start_epoch, elapsed0 = 0, 0.0
    if cfg.train.resume:
        try:
            state, start_epoch, elapsed0 = ckpt.restore(state, for_resume=True)
            log_fn(f"resumed from epoch {start_epoch}")
        except FileNotFoundError:
            log_fn("no checkpoint found; training from scratch")

    history = LossHistory(cfg.train.log_dir, cfg.model.name)
    t_start = time.time() - elapsed0

    # one-epoch-deep pipelining for the scanned path: the loss pull is the
    # only host sync, so it waits until the next epoch's arrays are built
    # and its steps enqueued, and then it waits for its own epoch only. A
    # checkpoint epoch resolves BEFORE the next epoch's steps, which update
    # the parameters in place.
    pending = None  # (epoch, (losses, copy event)) awaiting the sync

    def resolve(ep, pull, ckpt_state=None):
        losses, done = pull
        if done is not None:
            done.synchronize()
        mean_loss = (float(losses.float().mean())
                     if losses is not None else 0.0)
        elapsed = time.time() - t_start
        log_fn(
            f"epoch {ep + 1}/{cfg.train.num_epochs}: "
            f"loss={mean_loss:.5f} elapsed={elapsed:.1f}s"
        )
        history.append_loss(mean_loss, mean_loss, elapsed)
        if ckpt_state is not None and should_checkpoint(ep, cfg):
            path = ckpt.save(ckpt_state, ep, elapsed)
            log_fn(f"  checkpoint -> {path}")

    for epoch in range(start_epoch, cfg.train.num_epochs):
        # numpy seeds are 32-bit; fold the (seed, epoch) pair into range
        epoch_seed = (cfg.train.seed * 100003 + epoch) % (2**32)
        if epoch_fn is not None:
            arrays = sampler.epoch_arrays(epoch_seed, cfg.data.batch_size)
            if pending is not None and should_checkpoint(pending[0], cfg):
                resolve(*pending, ckpt_state=state)
                pending = None
            if arrays is None:
                losses = None
            else:
                if max_steps_per_epoch is not None:
                    arrays = tuple(a[:max_steps_per_epoch] for a in arrays)
                state, losses = epoch_fn(state, *arrays)
            pull = _start_pull(losses)
            if pending is not None:
                resolve(*pending)
            pending = (epoch, pull)
            continue
        batches = sampler.epoch_batches(epoch_seed=epoch_seed,
                                        batch_size=cfg.data.batch_size)
        if max_steps_per_epoch is not None:
            batches = itertools.islice(batches, max_steps_per_epoch)
        state, mean_loss = train_epoch(state, step_fn, batches)
        elapsed = time.time() - t_start
        log_fn(
            f"epoch {epoch + 1}/{cfg.train.num_epochs}: "
            f"loss={mean_loss:.5f} elapsed={elapsed:.1f}s"
        )
        history.append_loss(mean_loss, mean_loss, elapsed)
        if should_checkpoint(epoch, cfg):
            path = ckpt.save(state, epoch, elapsed)
            log_fn(f"  checkpoint -> {path}")

    if pending is not None:
        resolve(*pending, ckpt_state=state)

    return state, history
