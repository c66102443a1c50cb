"""Two probes behind the int8 long attention route and its trained gate.

``python -m deepmerge_tpu_torch.probes.long_route n64`` builds
``csrc/fused_block_q8.cu`` twice into ``build/probes/`` (as it is, with two
n32 P·V products at head width 64, and with one n64 product there), prints
the A registers of every ``IGMMA`` of the width-64 core in each build's
SASS and of every ``wgmma`` in its PTX, then holds each build's route
against its plain version at widths 32, 64 and 128, N 768 and 300, dynamic
and static scales, with the share of outputs that differ.

``python -m deepmerge_tpu_torch.probes.long_route determinism`` trains
v3-cube16 one epoch on ``chip_smoke.LONG_SCENE`` four times (default
algorithms, deterministic, deterministic, default) and prints whether two
trainings of a mode give bit-identical weights.

Run from the repository root on a machine with the card and ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
PROBE_DIR = REPO / "build" / "probes"

# q8_long_pv's width-64 branch as it is, and as one n64 product
N32 = """  } else {
    wgmma_s8_m64n32k32_rs(o, p, db);
    if constexpr (kD == 64)
      wgmma_s8_m64n32k32_rs<16>(o, p, db + ((32 * kAttnLongKeys) >> 4));
  }"""
N64 = """  } else if constexpr (kD == 64) {
    wgmma_s8_m64n64k32_rs(o, p, db);
  } else {
    wgmma_s8_m64n32k32_rs(o, p, db);
  }"""
CORE64 = "attention_q8_long_kernelILi64ELb0ELb0E"


def _variant(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """The csrc copy and build folder of one variant."""
    return PROBE_DIR / name / "csrc", PROBE_DIR / name / "lib"


def _a_operands(text: str, pattern: str) -> list[str]:
    return [m.group(1) for m in re.finditer(pattern, text)]


def build_variants() -> None:
    """Both builds and their PTX, in parallel; prints each width-64 core's
    A operands in SASS and PTX."""
    from deepmerge_tpu_torch.ops.kernels import build

    src = (REPO / "deepmerge_tpu_torch" / "csrc" / "fused_block_q8.cu").read_text()
    if src.count(N32) != 1:
        raise RuntimeError("q8_long_pv's width-64 branch is not the probe's")
    jobs = []
    for name, text in (("n32", src), ("n64", src.replace(N32, N64))):
        csrc, lib = _variant(name)
        shutil.rmtree(csrc.parent, ignore_errors=True)
        shutil.copytree(REPO / "deepmerge_tpu_torch" / "csrc", csrc)
        (csrc / "fused_block_q8.cu").write_text(text)
        lib.mkdir(parents=True)
        build.CSRC_DIR, build.BUILD_DIR = csrc, lib
        so = build.library_path("fused_block_q8")
        cu = str(csrc / "fused_block_q8.cu")
        nvcc = build.nvcc_path()
        jobs.append((name, so, csrc / "core.ptx", [
            subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(so), cu],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True),
            subprocess.Popen([nvcc, "-arch=sm_90a", "-std=c++17", "-O3",
                              "-ptx", "-o", str(csrc / "core.ptx"), cu],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)]))
    for name, so, ptx, procs in jobs:
        for p in procs:
            out = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"{name}: nvcc failed:\n{out}")
        cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(so)],
                              capture_output=True, text=True).stdout
        core = [f for f in re.split(r"\n(?=\s*Function : )", sass)
                if CORE64 in f.split("\n", 1)[0]]
        print(f"{name}: SASS IGMMA (accumulators, A) of the width-64 core: "
              + "; ".join(_a_operands(core[0], r"IGMMA\S* (R\d+, R\d+),")))
        text = ptx.read_text()
        fn = [f for f in re.split(r"\n(?=\.visible \.entry|\.entry)", text)
              if CORE64 in f.split("(", 1)[0]]
        print(f"{name}: PTX wgmma A operands of the width-64 core: "
              + "; ".join(_a_operands(fn[0], r"\}, \{(%r\d+), [^}]*\}, %rd")))


def check_variant(name: str) -> None:
    """The variant's long route against its plain version (run in its own
    process: the build folder is chosen before the first load)."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import build

    build.CSRC_DIR, build.BUILD_DIR = _variant(name)
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    static = torch.tensor([0.021, 0.023, 0.019], device=dev)
    for d in fb.CORE_WIDTHS:
        h = 768 // d
        for b, n in ((4, 768), (16, 300)):
            r = cs.device_randn(dev, d + n)
            qkv, bias = r(b, n, 3 * 768).to(torch.bfloat16), r(h, n, n, s=0.5)
            for st in (None, static):
                got = fb.attention_q8(qkv, bias, h, st).float()
                want = fb.attention_q8_ref(qkv, bias, h, st).float()
                bad = int((got != want).sum())
                print(f"{name} d={d} B={b} N={n} "
                      f"{'dynamic' if st is None else 'static'}: {bad} of "
                      f"{want.numel()} outputs differ from the plain version",
                      flush=True)


def determinism() -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from deepmerge_tpu_torch.config import ModelConfig
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene

    dev = torch.device("cuda", 0)
    scene = generate_scene(**cs.LONG_SCENE)
    first = {}
    for det in (False, True, True, False):
        t = time.perf_counter()
        w = cs.train_trusted(dev, scene, ModelConfig(cube=cs.LONG_CUBE), 1,
                             pairs=cs.LONG_TRAIN_PAIRS, deterministic=det)
        print(f"deterministic={det}: {time.perf_counter() - t:.1f} s")
        if det not in first:
            first[det] = w
            continue
        same = sum(torch.equal(w[k], first[det][k]) for k in w)
        worst = max(float((w[k].float() - first[det][k].float()).abs().max())
                    for k in w)
        print(f"deterministic={det}: two trainings, {same} of {len(w)} "
              f"tensors bit-identical, max |diff| {worst:.3e}", flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["n64"]:
        build_variants()
        for name in ("n32", "n64"):
            subprocess.run([sys.executable, "-m", __spec__.name, "check", name],
                           check=True)
    elif argv[:1] == ["check"]:
        check_variant(argv[1])
    elif argv[:1] == ["determinism"]:
        determinism()
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
