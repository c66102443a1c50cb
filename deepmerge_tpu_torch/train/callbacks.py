"""Loss history logging (copy of ``deepmerge_tpu/train/callbacks.py``;
reference ``callbacks.py:14-86``).

Appends per-epoch train/val loss (and elapsed seconds — the reference
reuses its f-score slot for wall time, ``Train_SMT.py:345-350``) to text
files under a timestamped log dir and re-renders a smoothed loss curve PNG
each epoch when matplotlib is available.
"""

from __future__ import annotations

import datetime
import os


class LossHistory:
    """``write=False`` keeps the history in memory only (the ranks of a
    data-parallel run other than rank 0)."""

    def __init__(self, log_dir: str = "logs", name: str = "loss",
                 write: bool = True):
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        self.save_path = os.path.join(log_dir, f"{name}_{stamp}")
        self.write = write
        if write:
            os.makedirs(self.save_path, exist_ok=True)
        self.train_losses: list[float] = []
        self.val_losses: list[float] = []
        self.elapsed: list[float] = []

    def append_loss(self, train_loss: float, val_loss: float | None = None,
                    elapsed: float = 0.0) -> None:
        val_loss = train_loss if val_loss is None else val_loss
        self.train_losses.append(float(train_loss))
        self.val_losses.append(float(val_loss))
        self.elapsed.append(float(elapsed))
        if not self.write:
            return
        with open(os.path.join(self.save_path, "epoch_loss.txt"), "a") as f:
            f.write(f"{train_loss}\n")
        with open(os.path.join(self.save_path, "epoch_val_loss.txt"), "a") as f:
            f.write(f"{val_loss}\n")
        with open(os.path.join(self.save_path, "epoch_time.txt"), "a") as f:
            f.write(f"{elapsed}\n")
        self._plot()

    def _plot(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        n = len(self.train_losses)
        xs = range(n)
        plt.figure()
        plt.plot(xs, self.train_losses, "red", linewidth=2, label="train loss")
        plt.plot(xs, self.val_losses, "coral", linewidth=2, label="val loss")
        if n >= 7:
            try:
                from scipy.signal import savgol_filter

                k = 5 if n < 25 else 15
                plt.plot(xs, savgol_filter(self.train_losses, k, 3), "green",
                         linestyle="--", linewidth=2, label="smooth train loss")
            except Exception:
                pass
        plt.grid(True)
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.legend(loc="upper right")
        # ONE file re-rendered each epoch (the reference overwrites a single
        # timestamped PNG, callbacks.py:60-84 — per-epoch files would leave
        # N images behind on a 100-epoch run)
        plt.savefig(os.path.join(self.save_path, "epoch_loss.png"))
        plt.close("all")
