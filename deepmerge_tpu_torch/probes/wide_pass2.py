"""Probes of the attention cores' wide form (heads wider than 256), whose
second pass computes S once a key block.

``python deepmerge_tpu_torch/probes/wide_pass2.py dump ROOT OUT`` imports
``deepmerge_tpu_torch`` from the checkout at ROOT (its kernels built into
ROOT's own build folder), runs K7, K6 (output and probabilities), K8 and
K4a's core (dynamic and static scales) on the wide form at d 384, 768 and
1536 and N 12, 48, 192, 257, 301 and 768 (every bias form) on inputs
drawn on the card from fixed seeds, saves the outputs to OUT, and prints
each kernel's time at
the main path's shapes (CUDA events, mean of 5 after a warm-up) with the
card's name and power limit, and the registers and spills ptxas gave the
wide kernels (and any note of wgmma serialization). Run it for two
checkouts (one unpacked under ``build/``), then ``compare A B`` prints
whether every output is ``torch.equal`` between the two.

``errors A.log B.log`` compares the error figures (rel err, max |err|, the
RMS, probabilities', saved residuals' and gradients' errors) of every
phase-3 line (those before phase 4's clock line) of two ``chip_smoke.py``
logs, line by line: how many match digit for digit.

``python deepmerge_tpu_torch/probes/wide_pass2.py route256`` times the
wide form against the width-256 instances at d 192 and 256 (C 768), N 12,
48, 192 and 768, both routes (K7; K4a's route, pre-pass and core), on the
same inputs: the wide form from a second build of a copy of the sources
whose ``core_width`` sends heads of 136..256 to it (the copy's one edit),
called through its C entry points with the scratch it needs, in turns
(256, wide, wide, 256); and whether their outputs are ``torch.equal``.

Run from the repository root on a machine with the card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
WIDTHS = (384, 768, 1536)
TOKENS = (12, 48, 192, 257, 301, 768)


def _import(root: str):
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    return fa, fb


def _randn(dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda *shape, s=1.0: torch.randn(shape, generator=g,
                                             device=dev) * s


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _case(d, n):
    """(heads, C, B) of a case: 2 heads of 384 or 1 of 768 at C 768, 1 of
    1536 at C 1536; B 64 (16 at N 768, 8 for K6 there)."""
    heads = 768 // d if d <= 768 else 1
    return heads, heads * d, 64 if n <= 257 else 16


def dump(root: str, out: str) -> None:
    import torch

    fa, fb = _import(root)
    from deepmerge_tpu_torch.ops.kernels import build

    build.start(["fused_attention", "fused_block_q8"])
    dev = torch.device("cuda", 0)
    bf = torch.bfloat16
    static = torch.tensor([0.021, 0.023, 0.019], device=dev)
    got = {}
    for d in WIDTHS:
        for n in TOKENS:
            heads, c, b = _case(d, n)
            r = _randn(dev, d + n)
            qkv, bias = r(b, n, 3 * c).to(bf), r(heads, n, n, s=0.5)
            q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, heads))
            key = f"d{d}-n{n}"
            got[f"K7 {key}"] = fa.attention_qkv(qkv, bias, heads)
            got[f"K8 {key}"] = fa.attention_bnhd(q, k, v, bias)
            bt = b if n <= 257 else 8
            o, p = fa.attention_probs(qkv[:bt].contiguous(), bias, heads)
            got[f"K6 {key}"], got[f"K6 probs {key}"] = o, p
            got[f"K4a {key}"] = fb.attention_q8(qkv, bias, heads)
            got[f"K4a static {key}"] = fb.attention_q8(qkv, bias, heads,
                                                       static)
    torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in got.items()}, out)
    print(f"{root}: {len(got)} outputs saved to {out} ({card()})")
    del got
    torch.cuda.empty_cache()
    _ptxas(root, build.build_logs)

    # times at the main path's shapes: K7, K8 and K4a's route at B 1024, N
    # 192 (and B 128, N 768 at d 768), K6 at B 240, N 192
    for d, n, b in ((384, 192, 1024), (768, 192, 1024), (1536, 192, 1024),
                    (768, 768, 128)):
        heads = 768 // d if d <= 768 else 1
        c = heads * d
        r = _randn(dev, 7 * d + n)
        qkv, bias = r(b, n, 3 * c).to(bf), r(heads, n, n, s=0.5)
        q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, heads))
        line = [f"K7 {cuda_ms(lambda: fa.attention_qkv(qkv, bias, heads)):.4f}",
                f"K8 {cuda_ms(lambda: fa.attention_bnhd(q, k, v, bias)):.4f}",
                f"K4a {cuda_ms(lambda: fb.attention_q8(qkv, bias, heads)):.4f}"]
        if n == 192 and d <= 768:
            q6 = qkv[:240].contiguous()
            line.append("K6 (B 240) "
                        f"{cuda_ms(lambda: fa.attention_probs(q6, bias, heads)):.4f}")
        print(f"{root}: d {d} B {b} N {n} ms: " + ", ".join(line), flush=True)
        del qkv, bias, q, k, v
        torch.cuda.empty_cache()


def compare(a: str, b: str) -> int:
    import torch

    x, y = torch.load(a), torch.load(b)
    bad = [k for k in x if not torch.equal(x[k], y[k])]
    print(f"{len(x) - len(bad)} of {len(x)} outputs torch.equal between "
          f"{a} and {b}" + (f"; differ: {bad}" if bad else ""))
    return 1 if bad or x.keys() != y.keys() else 0


_ERRORS = re.compile(r"(rel err|max \|err\||RMS err|saved|gradients)"
                     r" ([0-9.e+-]+)")


def errors(a: str, b: str) -> int:
    lines = []
    for path in (a, b):
        text = pathlib.Path(path).read_text().split("\nphase 4 at")[0]
        text = text.splitlines()
        lines.append([(ln.split(":")[0], _ERRORS.findall(ln)) for ln in text
                      if _ERRORS.search(ln) and not ln.startswith(" ")])
    x, y = lines
    same = sum(p == q for p, q in zip(x, y))
    print(f"{same} of {len(x)} lines with error figures match digit for "
          f"digit ({len(y)} in {b})")
    for p, q in zip(x, y):
        if p != q:
            print(f"  differ: {p} | {q}")
    return 0 if same == len(x) == len(y) else 1


def _ptxas(root, logs) -> None:
    """The wide kernels' registers and spills, and ptxas's warnings, from
    this process's build logs."""
    for name, log in sorted(logs.items()):
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "wide" in line and "Compiling entry" in line:
                print(f"{root}: {name}: {line.split(chr(39))[1][:70]}: "
                      + " | ".join(x.strip() for x in lines[i + 1:i + 4]))
            if "erializ" in line or "arning" in line:
                print(f"{root}: {name}: {line.strip()}")


def _variant_libs():
    """A copy of the sources in build/probes/wide128 whose core_width takes
    heads of 136..256 to the wide form, built there and loaded with
    ctypes."""
    from deepmerge_tpu_torch.ops.kernels import build

    out = REPO / "build" / "probes" / "wide128"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out)
    header = out / "block_common.cuh"
    text = header.read_text()
    assert text.count("d <= 256 ? 256") == 1, "core_width changed"
    header.write_text(text.replace("d <= 256 ? 256", "d <= 128 ? 256"))
    procs = {}
    for name in ("fused_attention", "fused_block_q8"):
        so = out / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs["fused_attention"].dm_attention.argtypes = [P, P, P, I, I, I, I, I,
                                                     P, P, L, P]
    libs["fused_block_q8"].dm_attention_q8.argtypes = [P, P, P, P, I, I, I,
                                                      I, I, P, P, L, P]
    return libs


def route256() -> int:
    import torch

    fa, fb = _import(str(REPO))
    from deepmerge_tpu_torch.ops.kernels import build

    build.start(["fused_attention", "fused_block_q8"])
    libs = _variant_libs()
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream
    print(f"card: {card()}")
    differ = 0
    for d in (192, 256):
        heads = 768 // d
        for n in (12, 48, 192, 768):
            b = 1024 if n <= 192 else 128
            r = _randn(dev, 3 * d + n)
            qkv, bias = r(b, n, 2304).to(torch.bfloat16), r(heads, n, n, s=0.5)
            plan = fb.attention_plan(b, n, heads, head_dim=d)
            ints = fb._plan_arg(plan["ints"])
            np_ = fb.q8_long_keys(n)
            p_bf = torch.empty((fb.wide_slots(b, n, heads, fb.WIDE_P_BLOCK),),
                               dtype=torch.uint8, device=dev)
            p_q8 = torch.empty((b * heads * (3 * np_ * 256 + 8 * np_ + 4 * 256)
                                + fb.wide_slots(b, n, heads, 128 * 64),),
                               dtype=torch.uint8, device=dev)

            def wide_k7():
                out = torch.empty((b, n, 768), dtype=torch.bfloat16,
                                  device=dev)
                err = libs["fused_attention"].dm_attention(
                    qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n,
                    768, heads, d, ints, p_bf.data_ptr(), p_bf.numel(),
                    stream())
                assert err == 0, f"dm_attention: CUDA error {err}"
                return out

            def wide_k4a():
                out = torch.empty((b, n, 768), dtype=torch.bfloat16,
                                  device=dev)
                err = libs["fused_block_q8"].dm_attention_q8(
                    qkv.data_ptr(), bias.data_ptr(), None, out.data_ptr(), b,
                    n, 768, heads, d, ints, p_q8.data_ptr(), p_q8.numel(),
                    stream())
                assert err == 0, f"dm_attention_q8: CUDA error {err}"
                return out

            for kn, inst, wide in (
                    ("K7", lambda: fa.attention_qkv(qkv, bias, heads),
                     wide_k7),
                    ("K4a route", lambda: fb.attention_q8(qkv, bias, heads),
                     wide_k4a)):
                same = torch.equal(inst(), wide())
                differ += not same
                t = [cuda_ms(f) for f in (inst, wide, wide, inst)]
                print(f"{kn} d {d} ({heads} heads) B {b} N {n}: 256 instance "
                      f"{t[0]:.4f} / {t[3]:.4f} ms, wide form {t[1]:.4f} / "
                      f"{t[2]:.4f} ms, outputs torch.equal: {same}",
                      flush=True)
            del qkv, bias, p_bf, p_q8
            torch.cuda.empty_cache()
    return 1 if differ else 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["dump"] and len(argv) == 3:
        dump(argv[1], argv[2])
    elif argv[:1] == ["compare"] and len(argv) == 3:
        return compare(argv[1], argv[2])
    elif argv[:1] == ["errors"] and len(argv) == 3:
        return errors(argv[1], argv[2])
    elif argv[:1] == ["route256"]:
        return route256()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
