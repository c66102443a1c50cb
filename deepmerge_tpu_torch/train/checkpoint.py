"""Checkpoint / resume (port of ``deepmerge_tpu/train/checkpoint.py``).

The payload is the reference's own ``torch.save`` dict ``{net, optimizer,
epoch, time, scales, depth, name}``, every 5 epochs and every epoch ≥ 90
(``Train_SMT.py:317-343``): ``net`` is the model's ``state_dict`` under the
reference names (for v4 and v5 with the aux heads' BatchNorm running
statistics), so the reference and ``deepmerge_tpu.compat.torch_import``
load it as they load a reference ``.pth``; ``optimizer`` is Adam's
``state_dict``. Resume restores the parameters, the Adam moments and the
step count (and so the dropout masks, which follow it) and the BatchNorm
statistics, and continues from ``epoch + 1`` (``:163-175``).

Each checkpoint is a directory ``{model.name}_epoch{NNNN}`` under the
checkpoint directory, as the JAX package names them, holding
``checkpoint.pth`` and ``meta.json`` (epoch, time, scales, depth, name,
the update count and the whole config).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from deepmerge_tpu_torch.config import Config
from deepmerge_tpu_torch.train.loop import TrainState

PAYLOAD = "checkpoint.pth"


def should_checkpoint(epoch: int, cfg: Config) -> bool:
    """Reference cadence: (epoch+1) % 5 == 0 or epoch+1 >= 90."""
    t = cfg.train
    return (epoch + 1) % t.checkpoint_every == 0 or (
        epoch + 1 >= t.checkpoint_tail_from
    )


class CheckpointManager:
    def __init__(self, directory: str, cfg: Config):
        # created lazily in save(): restore-only users must not mkdir
        self.directory = os.path.abspath(directory)
        self.cfg = cfg

    def _path(self, epoch: int) -> str:
        # model-name-stamped directory, analog of the reference's
        # date+name-stamped filename (Train_SMT.py:317-325)
        return os.path.join(
            self.directory, f"{self.cfg.model.name}_epoch{epoch + 1:04d}"
        )

    def save(self, state: TrainState, epoch: int, elapsed: float = 0.0) -> str:
        path = self._path(epoch)
        os.makedirs(path, exist_ok=True)
        mcfg = self.cfg.model
        payload = {
            "net": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "epoch": epoch,
            "time": elapsed,
            "scales": list(mcfg.input_image_scales),
            "depth": list(mcfg.depth),
            "name": mcfg.name,
        }
        torch.save(payload, os.path.join(path, PAYLOAD))
        meta = {
            "epoch": epoch,
            "time": elapsed,
            "scales": list(mcfg.input_image_scales),
            "depth": list(mcfg.depth),
            "name": mcfg.name,
            "step": state.step,
            "config": json.loads(self.cfg.to_json()),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return path

    def latest_path(self) -> Optional[str]:
        """Newest checkpoint of THIS model (by meta epoch).

        Filtered on the model-name prefix and ordered by the recorded
        epoch, so a shared checkpoint directory holding several runs never
        restores another model's payload into this state.
        """
        if not os.path.isdir(self.directory):
            return None
        prefix = f"{self.cfg.model.name}_epoch"
        best, best_epoch = None, -1
        for d in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, d)
            meta_path = os.path.join(full, "meta.json")
            if not d.startswith(prefix) or not os.path.exists(meta_path):
                continue
            try:
                with open(meta_path) as f:
                    epoch = int(json.load(f).get("epoch", -1))
            except (OSError, ValueError, json.JSONDecodeError):
                continue
            if epoch > best_epoch:
                best, best_epoch = full, epoch
        return best

    def restore(
        self,
        state: TrainState,
        path: Optional[str] = None,
        for_resume: bool = False,
    ) -> tuple[TrainState, int, float]:
        """Returns (state, start_epoch, elapsed), ``state`` updated in place.

        With ``for_resume=True`` (the resume-training path) a checkpoint
        at/past the final epoch raises like the reference
        (``Train_SMT.py:174-175``). Plain restores must not.
        """
        path = path or self.latest_path()
        if path is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        epoch = int(meta["epoch"])
        if for_resume and epoch + 1 >= self.cfg.train.num_epochs:
            # reference semantics (Train_SMT.py:174-175): resuming at or
            # past the schedule is an error
            raise ValueError(
                f"checkpoint epoch {epoch} is at/past num_epochs "
                f"{self.cfg.train.num_epochs}"
            )
        device = next(state.model.parameters()).device
        payload = torch.load(os.path.join(path, PAYLOAD),
                             map_location=device, weights_only=False)
        state.model.load_state_dict(payload["net"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(meta["step"])
        return state, epoch + 1, float(meta.get("time", 0.0))
