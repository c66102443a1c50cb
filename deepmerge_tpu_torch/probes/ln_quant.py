"""The w8a8 LayerNorm + quantize (``ops.kernels.fused_block.ln_quant``) at
the widest row of each of its forms, in one or two checkouts.

``python -m deepmerge_tpu_torch.probes.ln_quant [CHECKOUT [CHECKOUT]]``
builds ``csrc/fused_block_q8.cu`` of each checkout (default: this one), all
builds at once, then, each checkout in a process of its own (two of them
in the order first, second, second, first), runs the kernel at C 768,
1024, 1536, 2048, 3072, 4096 and 8192 on 196,608 rows (on as many bytes
as at 3072 above it), dynamic and static scales: its codes and row scales
against ``ln_quant_ref``, a digest of both (two checkouts that print the
same digest computed the same bits), and its mean time over 20 calls
(CUDA events) beside its bound, the bytes over 3.35 TB/s. The inputs come
from seed 39 on the card.

Run from the repository root on a machine with the card and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

WIDTHS = (768, 1024, 1536, 2048, 3072, 4096, 8192)
ROWS = 1024 * 192  # v3-wide's stage-0 rows at a chunk of 1024 points
STATIC_SCALE = 0.031
PEAK_BYTES = 3.35e12
REPS = 20


def _build() -> None:
    sys.path.insert(0, os.getcwd())
    from deepmerge_tpu_torch.ops.kernels import build

    t = time.perf_counter()
    build.build_all(["fused_block_q8"])
    print(f"[{os.getcwd()}] fused_block_q8.cu built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)


def _measure() -> None:
    """The kernel of the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(39)
    name = os.path.basename(os.getcwd())
    for c in WIDTHS:
        m = ROWS if c <= 3072 else ROWS * 3072 // c
        x = torch.randn(m, c, device=dev, generator=g).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(c, device=dev, generator=g)
        b = 0.1 * torch.randn(c, device=dev, generator=g)
        for static in (None, torch.tensor([STATIC_SCALE], device=dev)):
            mode = "dynamic" if static is None else "static"
            codes, scale = fb.ln_quant(x, w, b, static)
            want_c, want_s = fb.ln_quant_ref(x, w, b, static)
            diff = (codes.int() - want_c.int()).abs()
            flips = float((diff > 0).float().mean())
            s_err = float(((scale - want_s).abs() / want_s).max())
            digest = hashlib.sha256(codes.cpu().numpy().tobytes())
            digest.update(scale.cpu().numpy().tobytes())
            run = lambda: fb.ln_quant(x, w, b, static)
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / REPS
            bound = (m * c * 2 + 2 * c * 4 + m * c + m * 4) / PEAK_BYTES * 1e3
            print(f"[{name}] ln_quant M={m} C={c} {mode}: codes |diff| <= "
                  f"{int(diff.max())} on {flips:.2e} of them, scales rel err "
                  f"{s_err:.2e}, digest {digest.hexdigest()[:16]}; "
                  f"{ms:.4f} ms, bound {bound:.4f} ms ({bound / ms:.0%})",
                  flush=True)
            del codes, scale, want_c, want_s, diff
        del x
        torch.cuda.empty_cache()


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        _build()
        return 0
    if argv[:1] == ["--measure"]:
        _measure()
        return 0
    checkouts = [os.path.abspath(a) for a in argv] or [os.getcwd()]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip())
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build"], cwd=c)
              for c in checkouts]
    if any(p.wait() for p in builds):
        return 1
    order = checkouts + checkouts[::-1] if len(checkouts) > 1 else checkouts
    for c in order:
        if subprocess.run([sys.executable, me, "--measure"], cwd=c).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
