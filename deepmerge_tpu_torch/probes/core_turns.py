"""The attention cores and the blocks at head width 64 (12 heads, C 768),
and the cores at widths 32 and 128 (24 and 6 heads), in one or two
checkouts: what a change to the cores costs the widths that run unpadded.

``python -m deepmerge_tpu_torch.probes.core_turns [CHECKOUT [CHECKOUT]]``
builds ``csrc/fused_block.cu``, ``fused_block_q8.cu`` and
``fused_attention.cu`` of each checkout (default: this one), all builds at
once, then, each checkout in a process of its own (two of them in the
order first, second, second, first, first, second), prints the mean time
over 20 calls (10 for the long routes and the blocks; CUDA events) of K7
at B 1024 and N 192, 193 and 48, K8, K4a's core (dynamic and static
scales) and K6 (B 240) at N 192, K7 and K4a's long routes at B 128 and N
768, and the K2, K4 and K4a blocks at B 1024 and N 192; then, at widths
32 and 128, K7 and K4a's core (dynamic scales) at B 1024 and N 192 and
their long routes at B 128 and N 768. The inputs come from seeds on the
card (the blocks' from ``chip_smoke.block_inputs``).

Run from the repository root on a machine with the card and ``nvcc``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

C, HEADS = 768, 12


def _build() -> None:
    sys.path.insert(0, os.getcwd())
    from deepmerge_tpu_torch.ops.kernels import build

    t = time.perf_counter()
    build.build_all(["fused_block", "fused_block_q8", "fused_attention"])
    print(f"[{os.getcwd()}] built in {time.perf_counter() - t:.1f} s",
          flush=True)


def _measure() -> None:
    """The kernels of the checkout that is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    out = []

    def inputs(b, n, seed, heads=HEADS):
        g = torch.Generator(device=dev).manual_seed(seed)
        qkv = torch.randn((b, n, 3 * C), generator=g, device=dev).to(bf)
        bias = torch.randn((heads, n, n), generator=g, device=dev) * 0.5
        return qkv, bias

    def timed(what, fn, reps=20):
        out.append(f"{what} {cs.cuda_ms(fn, reps=reps):.4f}")

    for n in (192, 193, 48):
        qkv, bias = inputs(1024, n, n)
        timed(f"K7 N{n}", lambda: fa.attention_qkv(qkv, bias, HEADS))
        if n == 192:
            q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, HEADS))
            timed(f"K8 N{n}", lambda: fa.attention_bnhd(q, k, v, bias))
            st = torch.tensor([0.021, 0.023, 0.019], device=dev)
            timed(f"K4a dyn N{n}", lambda: fb.attention_q8(qkv, bias, HEADS))
            timed(f"K4a st N{n}",
                  lambda: fb.attention_q8(qkv, bias, HEADS, st))
            q240 = qkv[:240].contiguous()
            timed(f"K6 B240 N{n}",
                  lambda: fa.attention_probs(q240, bias, HEADS))
    qkv, bias = inputs(128, 768, 768)
    timed("K7 long N768", lambda: fa.attention_qkv(qkv, bias, HEADS), 10)
    timed("K4a long N768", lambda: fb.attention_q8(qkv, bias, HEADS), 10)
    del qkv, bias
    x, plist, _ = cs.block_inputs(1024, 192, 1, dev, seed=5)
    qp = fb.quantize_block_params(plist[0])
    timed("K2 N192", lambda: fb.fused_block(x, plist[0], HEADS), 10)
    timed("K4 N192", lambda: fb.fused_block_q8(x, qp, HEADS), 10)
    timed("K4a blk N192",
          lambda: fb.fused_block_q8(x, qp, HEADS, quant_attn=True), 10)
    del x, plist, qp
    for d in (32, 128):
        h = C // d
        for b, n, reps, tag in ((1024, 192, 20, ""), (128, 768, 10, "long ")):
            qkv, bias = inputs(b, n, n + d, h)
            timed(f"d{d} K7 {tag}N{n}",
                  lambda: fa.attention_qkv(qkv, bias, h), reps)
            timed(f"d{d} K4a {tag}N{n}",
                  lambda: fb.attention_q8(qkv, bias, h), reps)
            del qkv, bias
    print(f"[{os.path.basename(os.getcwd())}] " + "; ".join(out), flush=True)


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
    order = (checkouts + checkouts[::-1] + checkouts
             if len(checkouts) > 1 else checkouts)
    for c in order:
        if subprocess.run([sys.executable, me, "--measure"], cwd=c).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
