"""Time the nvcc builds of checkouts in turns, in ``chip_smoke.py``'s two
waves: patch_resize.cu and the source of K6 (attention_probs.cu, or
fused_attention.cu in a checkout without it) together, then every other
source of ``csrc/`` together, one nvcc each with the checkout's own flags
(its ``build.NVCC_FLAGS``). Prints each source's and each wave's seconds,
one line a turn, with the card's name and power limit.

    python -m deepmerge_tpu_torch.probes.build_waves build/parent .

runs the checkouts in the order A, B, B, A. The libraries go to a fresh
folder under the first checkout's ``build/`` and are deleted after each
turn. Run it on the machine with the card (it needs ``nvcc``, not the
card); nothing else should run beside it.
"""

from __future__ import annotations

import importlib.util
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

def _build_module(root: pathlib.Path, i: int):
    path = root / "deepmerge_tpu_torch" / "ops" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _waves(build) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """The checkout's two waves, as its chip_smoke.py builds them."""
    names = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    k6 = "attention_probs" if "attention_probs" in names else \
        "fused_attention"
    first = ("patch_resize", k6)
    return first, tuple(n for n in names if n not in first)


def _wave(build, names, out: pathlib.Path) -> dict[str, float]:
    """Start one nvcc a source of ``names`` together; each one's seconds."""
    t0 = time.perf_counter()
    procs = {}
    for n in names:
        with open(out / f"{n}.log", "w") as log:
            procs[n] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(out / f"{n}.so"), str(build.CSRC_DIR / f"{n}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
    done: dict[str, float] = {}
    while len(done) < len(procs):
        for n, p in procs.items():
            if n not in done and p.poll() is not None:
                done[n] = time.perf_counter() - t0
                if p.returncode:
                    raise RuntimeError(f"nvcc failed on {n}.cu:\n"
                                       + (out / f"{n}.log").read_text())
        time.sleep(0.05)
    return done


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [pathlib.Path(a).resolve() for a in argv]
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {out}")
    scratch = roots[0] / "build" / "probes"
    scratch.mkdir(parents=True, exist_ok=True)
    for i, k in enumerate((0, 1, 1, 0)):
        build = _build_module(roots[k], i)
        tmp = pathlib.Path(tempfile.mkdtemp(dir=scratch))
        try:
            times = [_wave(build, w, tmp) for w in _waves(build)]
        finally:
            shutil.rmtree(tmp)
        per = ", ".join(f"{n} {s:.1f}" for w in times for n, s in w.items())
        print(f"turn {i} {argv[k]}: wave 1 {max(times[0].values()):.1f} s, "
              f"wave 2 {max(times[1].values()):.1f} s ({per})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
