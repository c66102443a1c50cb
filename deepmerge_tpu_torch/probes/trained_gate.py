"""The trained-weight gate of a long shape at several epoch counts.

``python -m deepmerge_tpu_torch.probes.trained_gate CONFIG EPOCHS EVERY``
trains ``chip_smoke``'s configuration CONFIG (``v3-cube16`` or ``v3-wide``,
``chip_smoke.TRAINED_CONFIGS``: its pairs a step, on ``LONG_SCENE``) for
EPOCHS epochs under torch's deterministic algorithms, keeping a checkpoint
every EVERY epochs, then runs phase 8b's or 8c's gates
(``chip_smoke.long_trained_phase``) on each checkpoint's weights, with the
gates' failures printed rather than raised. The learning rate is constant
before epoch 40 and each epoch's batches follow (seed, epoch) alone, so the
weights after k epochs are those of a k-epoch run: one training reads every
count the script could choose.

Run from the repository root on a machine with the card and ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib
import sys
import tempfile
import time
import warnings

REPO = pathlib.Path(__file__).resolve().parents[2]


def main(argv) -> int:
    import torch
    import torch.utils.deterministic

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from deepmerge_tpu_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.ops.kernels import build
    from deepmerge_tpu_torch.train.driver import train

    config, epochs, every = argv[0], int(argv[1]), int(argv[2])
    kw, _, _, pairs = cs.TRAINED_CONFIGS[config]
    build.build_all(["patch_resize", "attention_probs", "fused_attention",
                     "fused_block", "fused_block_q8", "label_lookup"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader", "-i", "0"])
    print(card)
    cs.require = lambda ok, msg: ok or print(f"gate failed: {msg}")
    root = tempfile.mkdtemp(prefix="trained_gate_")
    cfg = Config(model=ModelConfig(**kw),
                 data=DataConfig(batch_size=pairs, max_window=512),
                 train=TrainConfig(num_epochs=epochs, checkpoint_every=every,
                                   checkpoint_tail_from=10 ** 6,
                                   checkpoint_dir=os.path.join(root, "ck"),
                                   log_dir=os.path.join(root, "logs")))
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*CuBLAS.*")
        train(cfg, scene=generate_scene(**cs.LONG_SCENE),
              log_fn=lambda m: print(m, flush=True), device=dev)
    torch.cuda.synchronize()
    print(f"trained {epochs} epochs of {pairs} pairs in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    for e in range(every, epochs + 1, every):
        path = os.path.join(root, "ck", f"{cfg.model.name}_epoch{e:04d}",
                            "checkpoint.pth")
        net = torch.load(path, map_location="cpu", weights_only=False)["net"]
        print(f"{config} at {e} epochs:", flush=True)
        cs.long_trained_phase(dev, card, config, trained=net)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
