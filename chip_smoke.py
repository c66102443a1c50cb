#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``deepmerge_tpu_torch``) at the flagship S2Former-v3
widths with random seeded weights, after checking each hand-written CUDA
kernel against its plain PyTorch version on the card:

  1. the card, and the torch, CUDA and nvcc versions;
  2. the kernel build (one nvcc per ``deepmerge_tpu_torch/csrc`` source, all
     started together), with ptxas's register and spill lines;
  3. each kernel against its plain version, at the main path's shapes (and
     at batch 64 for the block kernels), with its time beside the plain
     version's; the w8a8 kernels (K4) with dynamic and with static scales,
     also at the serving walk's batch of 2048;
  4. the bf16 slice: ``FeatureExtractor.segment_scene_device`` on a 1024²
     scene with 2043 sample points, every kernel's launch count over that
     run, the median time of three runs, one profiled run (the device's busy
     share and its time by kernel), and the same slice with the plain
     versions on the card as the reference (the embeddings' RMS error and
     the share of first-round merge decisions that differ held to their
     bounds, the label disagreement of the maps printed: on random weights
     the merge amplifies a few edges, see ``TOL_EMB_RMS``);
  5. the same slice with ``quantize="w8a8"`` (K1 and K4 launched, K2 and K3
     not), checked the same way, its label disagreement with the bf16
     slice printed; then one ``w8a8-static`` run, calibrated on its first
     chunk; then the same slice on v5 (the designed-feature token in the
     sequence, N = 193/49/13), in w8a8 (K1 and K4, not K2, K3, K7 or K8)
     and at the reference's erf GELU in bf16 (K1 and K7, 12 launches a
     chunk, no block kernel, no K8), each timed, profiled and held to the
     plain versions;
  6. the serving walk: ``process_folder`` with ``quantize="w8a8"`` and
     label maps over four 2048² scenes of 8192 regions in the reference
     folder layout, each scene's ``simi``, merged map and stored embeddings
     checked, and the steady-state MPix/s from the gaps between completions;
     then its first scene again through ``process_scene``, profiled (busy
     share), and on the plain versions (its embeddings and its first-round
     merge decisions held to theirs);
  7. training: ``train.driver.train`` on the flagship at 120 pairs a step
     (a forward batch of 240) for two epochs of eight steps on the 1024²
     scene, checkpointing every epoch: K6 launched 12 times a step and K1
     launched, no block kernel; finite losses; the last checkpoint restores
     the parameters and Adam's moments; the median step time, pairs/s,
     peak memory and one profiled step; and four steps from the same
     weights and batches on the plain versions, their losses held to the
     kernels'. Then the same for v5 with its aux losses at weights
     (0.1, 0.2): K6 12 times a step at N = 193/49/13, the aux
     heads' BatchNorm statistics moved and restored exactly, the plain
     versions' four steps drawing the same dropout masks.

Phase 3 also holds the saved-probs training attention (K6) against its
plain version at the training batch and every stage's sequence length,
forward and backward, and, at the lengths v5 and v1 bring (193/49/13 and
256), the attention-only kernels K7 and K8 (beside the time of
``scaled_dot_product_attention``), K2, K4 and K6. The second-to-last line
is a JSON object with one
entry per kernel (its time, its plain version's, and its bound: the least
time the card could take for the same work, from the bytes it must move
and the operations it must do at the H100's published peaks); the last
line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without those lines; so does a run without CUDA
or outside the repository. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

# Largest error relative to max|plain| that each kernel may show. The gather
# is a copy, so it must be exact. The block kernels round to bf16 (8
# significant bits, one ulp = 2^-8 relative) at the same points as the plain
# version but sum each product in another order, so a rounding can differ
# by one ulp and carry through the block; 2e-2 allows a few ulps of the
# output scale for one block, 3e-2 for a stage of up to four.
# The w8a8 kernels are held to the same bounds: their s32 sums are exact,
# but an f32 LayerNorm or GELU output one ulp apart can flip an int8 code on
# a rounding boundary (one quant step), on top of the bf16 roundings.
# A block's output keeps its residual input x (N(0, 1) here), so max|plain|
# is mostly x's, and those bounds let through an absolute error of about
# 0.13, more than a whole bias term of the block. They catch a fault that
# spoils a few rows; the RMS error of the block's own contribution (out - x)
# over that contribution's RMS catches a term that is small everywhere. At
# the flagship widths on an H100 the kernels show 0.003 for one block,
# 0.005 for a stage of two and 0.013 for a w8a8 stage of four; the plain
# version with one bias of the block left out shows 0.034 or more.
TOL_GATHER = 0.0
TOL_BLOCK = 2e-2
TOL_CHAIN = 3e-2
TOL_BLOCK_RMS = 1e-2
TOL_CHAIN_RMS = 2.5e-2
LABEL_DISAGREEMENT_MAX = 0.005  # BASELINE.md's parity bar
# The serving walk's merge (absolute threshold 1.0, up to 16 rounds) joins
# about a third of the edges of a random-weight scene in its first round,
# close to where the clusters start to percolate, so a few edges decided
# the other way can move a large cluster: on an H100 the bf16 kernels (K2,
# K3) differ from their plain versions by 1.9% of the merged map on the
# first walk scene and w8a8 (K4) by 2.3%, and the plain embeddings plus
# noise of the kernels' RMS error move it by 1.1%. That scene is therefore
# held where the kernels act, before the merge amplifies: the embeddings'
# RMS error over their RMS (0.007 measured) and the share of edges whose
# first-round merge decision differs (0.0028 measured, 0.0015 with bf16).
# The slices' median-threshold merge amplifies too: with the kernels
# unchanged, the bf16 slice's map disagreed with the plain versions' by 0
# on one draw of random weights and by 1.07% on another, w8a8's by 0.04%
# and 0.62%, while the embeddings' RMS error (0.004) and the merge
# decisions that differ (0.0014) hardly moved. Every slice is therefore
# held on those two measures, and its map disagreement is printed
# against the parity bar, which needs trained weights to say anything.
TOL_EMB_RMS = 2e-2
EDGE_FLIPS_MAX = 0.005
# K6 (saved-probs attention): its output is held like a block's (bf16
# roundings at the same points, sums in other orders); its probabilities,
# bf16 values in [0, 1], to 1e-2 absolute, a few bf16 ulps at 1; the
# gradients of qkv and of the bias through the autograd function, kernel
# forward against plain forward (the backward is the same torch code), to
# 2e-2 of their largest magnitude: a probability one ulp apart moves the
# products it enters by that ulp.
TOL_K6_OUT = 2e-2
TOL_K6_PROBS = 1e-2
TOL_K6_GRAD = 2e-2
# K7 and K8 (the attention alone): their output as K6's. K7's gradients
# (held as K6's) do not depend on its forward: the backward recomputes the
# attention in float32 from the saved qkv and bias, so the check covers the
# autograd path.
TOL_K7 = 2e-2
# Training on the kernels against the plain versions, four steps from the
# same weights and batches: the step-0 loss differs only by the bf16
# roundings of K6's forward (K1 is exact), 1e-2 relative; later steps
# carry the updates those roundings changed, 3e-2.
TOL_TRAIN_LOSS0 = 1e-2
TOL_TRAIN_LOSS = 3e-2

# The H100 SXM's published peaks (dense, 700 W), for the kernels' bounds
PEAK_BYTES = 3.35e12   # HBM bytes/s
PEAK_BF16 = 989e12     # bf16 tensor-core FLOP/s
PEAK_INT8 = 1979e12    # int8 tensor-core OP/s

SCENE = dict(h=1024, w=1024, n_regions=2048, n_objects=256,
             points_per_region=1, seed=0)
# bench.py's BENCH_SERVE defaults: 2048² scenes at 8192 regions, 256
# objects, one point per region, deflate rasters, chunks of 2048 points
SERVE_SCENES = 4
SERVE_SCENE = dict(h=2048, w=2048, n_regions=8192, n_objects=256,
                   points_per_region=1)
SERVE_BATCH = 2048
# training: DataConfig().batch_size pairs a step, stacked [left; right] into
# a forward batch of twice that; two epochs of at most eight steps
TRAIN_PAIRS = 120
TRAIN_EPOCHS = 2
TRAIN_STEPS = 8


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def run_cmd(args):
    try:
        out = subprocess.run(args, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (out.stdout or out.stderr).strip()


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


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def bound(nbytes, bf16_flops=0.0, int8_ops=0.0):
    """The least time the card could take for a function: the larger of
    the bytes it must move (each input read once, each output written
    once) over the memory rate and its operations over the peak rate of
    their type. Returns ``bound_ms`` and ``bound_by``."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = bf16_flops / PEAK_BF16 + int8_ops / PEAK_INT8
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def block_work(b, n, depth, q8=False, c=768, heads=12, hidden=3072):
    """(bytes, bf16 FLOPs, int8 ops) of ``depth`` blocks run back to back
    on a (b, n, c) bf16 activation: the activation read and the output
    written once, each block's weights (int8 with f32 scales when ``q8``),
    biases, LayerNorm parameters and f32 attention bias read once; the four
    GEMMs (int8 when ``q8``) and the attention's q·kᵀ and p·v in bf16."""
    m = b * n
    weights = 4 * c * c + 2 * c * hidden
    per_block = (weights * (1 if q8 else 2) + (4 * c + hidden) * 2
                 + 4 * c * 4 + heads * n * n * 4
                 + ((4 * c + hidden) * 4 if q8 else 0))
    nbytes = 2 * m * c * 2 + depth * per_block
    gemm = 2 * m * weights
    attn = 4 * b * n * n * c
    if q8:
        return nbytes, depth * attn, depth * gemm
    return nbytes, depth * (gemm + attn), 0.0


def add_work(*works):
    return tuple(sum(w[i] for w in works) for i in range(3))


def check_block(what, got, want, x, tol, tol_rms):
    """A block kernel's output against its plain version on input ``x``:
    the largest error over max|plain| (at most ``tol``) and the RMS error
    of the block's contribution ``plain - x`` over its RMS (at most
    ``tol_rms``). Returns the largest absolute error and a line of all
    three."""
    d = got.float() - want.float()
    contrib = want.float() - x.float()
    err = float(d.abs().max() / want.float().abs().max())
    aerr = float(d.abs().max())
    rms = float(d.pow(2).mean().sqrt() / contrib.pow(2).mean().sqrt())
    require(err <= tol, f"{what} differs from plain: {err} > {tol}")
    require(rms <= tol_rms, f"{what}: RMS error of the block's contribution "
            f"{rms} > {tol_rms}")
    return aerr, (f"rel err {err:.3e} (tol {tol}), max |err| {aerr:.3e}, "
                  f"contribution RMS err {rms:.3e} (tol {tol_rms})")


def block_inputs(b, n, depth, dev, seed):
    """Random bf16 activations and ``depth`` blocks of flagship-width
    parameters (C 768, 12 heads, MLP 3072) on the card."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    c, heads, hidden = 768, 12, 3072

    def r(*shape, s=0.02):
        return torch.from_numpy(
            (rs.standard_normal(shape) * s).astype(np.float32)).to(dev)

    bf = torch.bfloat16
    plist = [
        (1.0 + r(c, s=0.1), r(c, s=0.1), r(3 * c, c).to(bf), r(3 * c).to(bf),
         r(heads, n, n, s=0.5), r(c, c).to(bf), r(c).to(bf),
         1.0 + r(c, s=0.1), r(c, s=0.1), r(hidden, c).to(bf),
         r(hidden).to(bf), r(c, hidden).to(bf), r(c).to(bf))
        for _ in range(depth)
    ]
    x = torch.from_numpy(
        rs.standard_normal((b, n, c)).astype(np.float32)).to(dev, bf)
    return x, plist, heads


def check_kernels(dev, ds, scene):
    """Phase 3: each kernel against its plain version on the card."""
    import torch

    from deepmerge_tpu_torch.ops import patches
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    results = {}

    # K1 at the main path's shapes: chunks of 256 points, every slot
    c = ds.padded.shape[-1]
    scene2d = ds.padded.reshape(ds.padded.shape[0], -1)
    pad = patches.scene_pad(ds.caps, c)
    a_px = patches._pixel_align(c)
    centers = torch.as_tensor(scene.regions.points_yx, dtype=torch.int32,
                              device=dev)
    worst, n_calls, last = 0.0, 0, None
    for slot, cap in enumerate(ds.caps):
        rows, cols = cap + wg.ROW_ALIGN, (cap + a_px) * c
        for s in range(0, centers.shape[0], 256):
            starts, _, _ = patches.window_starts(centers[s : s + 256], cap,
                                                 pad, c)
            got = wg.gather_windows(scene2d, starts, rows, cols)
            want = wg.gather_windows_ref(scene2d, starts, rows, cols)
            worst = max(worst, abs_err(got, want))
            n_calls += 1
            if starts.shape[0] == 256:
                last = (starts, rows, cols)
    require(worst <= TOL_GATHER, f"window gather differs from plain: {worst}")
    starts, rows, cols = last
    ms = cuda_ms(lambda: wg.gather_windows(scene2d, starts, rows, cols))
    plain_ms = cuda_ms(lambda: wg.gather_windows_ref(scene2d, starts, rows,
                                                     cols))
    # the PyTorch call that computes the same gather: one advanced-indexing
    # read with the index grids already built
    ri = starts[:, 0:1].long() + torch.arange(rows, device=dev)
    ci = starts[:, 1:2].long() + torch.arange(cols, device=dev)
    library_ms = cuda_ms(lambda: scene2d[ri[:, :, None], ci[:, None, :]])
    b1 = bound(2 * starts.shape[0] * rows * cols + starts.numel() * 4)
    print(f"K1 window_gather: {n_calls} calls (3 slots x 256-point chunks, "
          f"windows {rows}x{cols} B), max |err| {worst} (tol {TOL_GATHER}, "
          f"bit-exact); 256 points: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"indexing call {library_ms:.4f} ms, bound {b1['bound_ms']:.4f} "
          f"ms ({b1['bound_by']})")
    results["window_gather"] = dict(max_abs_err=worst, ms=ms,
                                    plain_ms=plain_ms, library_ms=library_ms,
                                    **b1)

    # K2 at batch 64 and at the main path's chunk of 1024, stage-0 shapes
    k2 = []
    for b in (64, 1024):
        x, plist, heads = block_inputs(b, 192, 1, dev, seed=b)
        got = fb.fused_block(x, plist[0], heads)
        want = fb.block_ref(x, plist[0], heads)
        aerr, errs = check_block(f"fused_block (B={b})", got, want, x,
                                 TOL_BLOCK, TOL_BLOCK_RMS)
        ms = cuda_ms(lambda: fb.fused_block(x, plist[0], heads))
        plain_ms = cuda_ms(lambda: fb.block_ref(x, plist[0], heads), reps=2)
        b2 = bound(*block_work(b, 192, 1))
        print(f"K2 fused_block B={b} N=192 C=768 H=12: {errs}; {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {b2['bound_ms']:.3f} ms "
              f"({b2['bound_by']})")
        k2.append(dict(max_abs_err=aerr, ms=ms, plain_ms=plain_ms,
                       library_ms=None, **b2))
        del x, plist, got, want
    results["fused_block"] = k2[-1]

    # K3: stage 1 (N=48, 4 blocks) and stage 2 (N=12, 2 blocks)
    per_stage = {}
    for b in (64, 1024):
        for n, depth in ((48, 4), (12, 2)):
            x, plist, heads = block_inputs(b, n, depth, dev, seed=b + n)
            got = fb.fused_block_chain(x, plist, heads)
            want = fb.chain_ref(x, plist, heads)
            aerr, errs = check_block(
                f"fused_block_chain (B={b}, N={n}, depth {depth})", got, want,
                x, TOL_CHAIN, TOL_CHAIN_RMS)
            ms = cuda_ms(lambda: fb.fused_block_chain(x, plist, heads))
            plain_ms = cuda_ms(lambda: fb.chain_ref(x, plist, heads), reps=2)
            print(f"K3 fused_block_chain B={b} N={n} depth {depth}: {errs}; "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
            per_stage[(b, n)] = dict(max_abs_err=aerr, ms=ms,
                                     plain_ms=plain_ms)
    # the JSON line reports the main path's chunk: both stages summed
    s1, s2 = per_stage[(1024, 48)], per_stage[(1024, 12)]
    b3 = bound(*add_work(block_work(1024, 48, 4), block_work(1024, 12, 2)))
    print(f"K3 at B=1024, both stages: bound {b3['bound_ms']:.3f} ms "
          f"({b3['bound_by']})")
    results["fused_block_chain"] = dict(
        max_abs_err=max(s1["max_abs_err"], s2["max_abs_err"]),
        ms=s1["ms"] + s2["ms"], plain_ms=s1["plain_ms"] + s2["plain_ms"],
        library_ms=None, **b3,
    )
    return results


def check_k4(dev):
    """Phase 3, w8a8: K4's block (N=192) and chain (N=48 x 4, N=12 x 2) at
    batch 64, at the slices' chunk of 1024 and at the serving walk's chunk
    of ``SERVE_BATCH``, with dynamic scales and with static scales from
    ``block_act_amax`` on the same input (block by block along the plain
    chain)."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    results = {}
    for b in (64, 1024, SERVE_BATCH):
        for n, depth in ((192, 1), (48, 4), (12, 2)):
            x, plist, heads = block_inputs(b, n, depth, dev, seed=b + n + 1)
            for static in (False, True):
                qps, h = [], x
                for p in plist:
                    amax = fb.block_act_amax(h, p, heads)[1] if static else None
                    qp = fb.quantize_block_params(p, amax)
                    h = fb.block_ref_q8(h, qp, heads).to(x.dtype)
                    qps.append(qp)
                if depth == 1:
                    name, tol, tol_rms = ("fused_block_q8", TOL_BLOCK,
                                          TOL_BLOCK_RMS)
                    run = lambda: fb.fused_block_q8(x, qps[0], heads)
                    plain = lambda: fb.block_ref_q8(x, qps[0], heads)
                else:
                    name, tol, tol_rms = ("fused_block_chain_q8", TOL_CHAIN,
                                          TOL_CHAIN_RMS)
                    run = lambda: fb.fused_block_chain_q8(x, qps, heads)
                    plain = lambda: fb.chain_ref_q8(x, qps, heads)
                got, want = run(), plain()
                mode = "static" if static else "dynamic"
                aerr, errs = check_block(
                    f"{name} (B={b}, N={n}, depth {depth}, {mode})", got,
                    want, x, tol, tol_rms)
                ms = cuda_ms(run)
                plain_ms = cuda_ms(plain, reps=2)
                print(f"K4 {name} B={b} N={n} depth {depth} {mode}: {errs}; "
                      f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
                results[(name, b, n, mode)] = dict(
                    max_abs_err=aerr, ms=ms, plain_ms=plain_ms)
                del got, want, qps, h
            del x, plist
            torch.cuda.empty_cache()
    # the JSON line reports the main path's chunk with dynamic scales, the
    # chain's two stages summed
    s1 = results[("fused_block_chain_q8", 1024, 48, "dynamic")]
    s2 = results[("fused_block_chain_q8", 1024, 12, "dynamic")]
    b4 = bound(*block_work(1024, 192, 1, q8=True))
    b4c = bound(*add_work(block_work(1024, 48, 4, q8=True),
                          block_work(1024, 12, 2, q8=True)))
    print(f"K4 at B=1024: block bound {b4['bound_ms']:.3f} ms "
          f"({b4['bound_by']}), chain (both stages) bound "
          f"{b4c['bound_ms']:.3f} ms ({b4c['bound_by']})")
    return {
        "fused_block_q8": dict(
            results[("fused_block_q8", 1024, 192, "dynamic")],
            library_ms=None, **b4),
        "fused_block_chain_q8": dict(
            max_abs_err=max(s1["max_abs_err"], s2["max_abs_err"]),
            ms=s1["ms"] + s2["ms"], plain_ms=s1["plain_ms"] + s2["plain_ms"],
            library_ms=None, **b4c),
    }


def check_k6(dev):
    """Phase 3, training: K6 against its plain version at the training
    batch (``TRAIN_PAIRS`` stacked twice) and each stage's sequence length,
    flagship widths; the backward through the autograd function on the
    kernel's forward against the plain forward. Returns the stage-0 entry
    of the JSON line."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa

    b, c, heads = 2 * TRAIN_PAIRS, 768, 12
    results = {}
    for n in (192, 48, 12):
        rs = np.random.default_rng(n + 7)
        r = lambda *shape, s=1.0: torch.from_numpy(
            (rs.standard_normal(shape) * s).astype(np.float32)).to(dev)
        qkv = r(b, n, 3 * c).to(torch.bfloat16)
        bias = r(heads, n, n, s=0.5)
        g = r(b, n, c).to(torch.bfloat16)
        out, probs = fa.attention_probs(qkv, bias, heads)
        want_out, want_probs = fa.attention_probs_ref(qkv, bias, heads)
        out_err, probs_err = rel_err(out, want_out), abs_err(probs, want_probs)
        require(out_err <= TOL_K6_OUT, f"K6 out (N={n}) differs from plain: "
                f"{out_err} > {TOL_K6_OUT}")
        require(probs_err <= TOL_K6_PROBS, f"K6 probs (N={n}) differ from "
                f"plain: {probs_err} > {TOL_K6_PROBS}")

        def grads():
            q = qkv.clone().requires_grad_(True)
            bb = bias.clone().requires_grad_(True)
            fa.fused_attention_train(q, bb, heads).backward(g)
            return q.grad, bb.grad

        got = grads()
        with mock.patch.object(fa, "attention_probs", fa.attention_probs_ref):
            want = grads()
        dq_err, db_err = rel_err(got[0], want[0]), rel_err(got[1], want[1])
        require(dq_err <= TOL_K6_GRAD and db_err <= TOL_K6_GRAD,
                f"K6 backward (N={n}): dqkv {dq_err}, dbias {db_err} > "
                f"{TOL_K6_GRAD}")
        ms = cuda_ms(lambda: fa.attention_probs(qkv, bias, heads))
        plain_ms = cuda_ms(lambda: fa.attention_probs_ref(qkv, bias, heads),
                           reps=2)
        nbytes = (qkv.numel() * 2 + bias.numel() * 4 + out.numel() * 2
                  + probs.numel() * 2)
        b6 = bound(nbytes, bf16_flops=4 * b * n * n * c)
        print(f"K6 attention_probs B={b} N={n} C={c} H={heads}: out rel err "
              f"{out_err:.3e} (tol {TOL_K6_OUT}), probs max |err| "
              f"{probs_err:.3e} (tol {TOL_K6_PROBS}); backward dqkv "
              f"{dq_err:.3e}, dbias {db_err:.3e} (tol {TOL_K6_GRAD}); "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{b6['bound_ms']:.4f} ms ({b6['bound_by']})")
        results[n] = dict(max_abs_err=abs_err(out, want_out), ms=ms,
                          plain_ms=plain_ms, library_ms=None, **b6)
        del qkv, bias, g, out, probs, want_out, want_probs, got, want
        torch.cuda.empty_cache()
    return {"fused_attention_train": results[192]}


def attention_library_ms(q, k, v, bias):
    """The time of one ``scaled_dot_product_attention`` call on (B, H, N,
    D) q, k, v with the bias as its additive mask: the yardstick of K7 and
    K8 (the port never calls it)."""
    import torch.nn.functional as F

    mask = bias.to(q.dtype)[None]
    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask))


def check_wide_tokens(dev):
    """Phase 3, the sequence lengths v5 (N = 193/49/13, its extra token)
    and v1 (N = 256) bring: the attention-only kernels K7 (packed qkv) and
    K8 ((B, N, H, D)) against their plain versions, with the time of
    ``scaled_dot_product_attention`` beside them and K7's gradients through
    its autograd function; then K2 (one block), K4 (v5's stage-0 block and
    stage-1/2 chains, dynamic scales) and K6 at v5's lengths and K6 at 256.
    Returns the JSON entries of K7 (the v5 stage-0 shape, B 1024, N 193)
    and K8 (B 1024, N 192)."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    c, heads = 768, 12
    bf = torch.bfloat16

    def attention_inputs(b, n, seed):
        rs = np.random.default_rng(seed)
        r = lambda *shape, s=1.0: torch.from_numpy(
            (rs.standard_normal(shape) * s).astype(np.float32)).to(dev)
        return r(b, n, 3 * c).to(bf), r(heads, n, n, s=0.5)

    def attention_work(b, n):
        # q, k, v read, out written, bias read; q·kᵀ and p·v
        return bound(b * n * 4 * c * 2 + heads * n * n * 4,
                     bf16_flops=4 * b * n * n * c)

    results = {}
    for b, n in ((1024, 192), (1024, 48), (1024, 12), (1024, 193),
                 (1024, 49), (1024, 13), (256, 256)):
        qkv, bias = attention_inputs(b, n, b + n)
        got = fa.attention_qkv(qkv, bias, heads)
        want = fa.attention_qkv_ref(qkv, bias, heads)
        err = rel_err(got, want)
        require(err <= TOL_K7, f"K7 (B={b}, N={n}) differs from plain: "
                f"{err} > {TOL_K7}")
        ms = cuda_ms(lambda: fa.attention_qkv(qkv, bias, heads))
        plain_ms = cuda_ms(lambda: fa.attention_qkv_ref(qkv, bias, heads),
                           reps=2)
        q, k, v = (t.permute(0, 2, 1, 3).contiguous()
                   for t in fa.split_qkv(qkv, heads))
        lib_ms = attention_library_ms(q, k, v, bias)
        bk = attention_work(b, n)
        print(f"K7 attention_qkv B={b} N={n} C={c} H={heads}: rel err "
              f"{err:.3e} (tol {TOL_K7}); {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, SDPA {lib_ms:.4f} ms, bound {bk['bound_ms']:.4f} ms "
              f"({bk['bound_by']})")
        results[("K7", b, n)] = dict(max_abs_err=abs_err(got, want), ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms,
                                     **bk)
        del qkv, bias, got, want, q, k, v
        torch.cuda.empty_cache()

    # K7's backward (the float32 recompute, the same torch code on both
    # sides) on the kernel's forward against the plain forward
    qkv, bias = attention_inputs(64, 193, 5)
    g = attention_inputs(64, 193, 6)[0][..., :c].contiguous()

    def grads():
        qq = qkv.clone().requires_grad_(True)
        bb = bias.clone().requires_grad_(True)
        fa.fused_attention_qkv(qq, bb, heads).backward(g)
        return qq.grad, bb.grad

    got = grads()
    with mock.patch.object(fa, "attention_qkv", fa.attention_qkv_ref):
        want = grads()
    dq_err, db_err = rel_err(got[0], want[0]), rel_err(got[1], want[1])
    require(dq_err <= TOL_K6_GRAD and db_err <= TOL_K6_GRAD,
            f"K7 backward: dqkv {dq_err}, dbias {db_err} > {TOL_K6_GRAD}")
    print(f"K7 backward B=64 N=193: dqkv {dq_err:.3e}, dbias {db_err:.3e} "
          f"(tol {TOL_K6_GRAD})")

    # K8 at the serving chunk, stage-0 length, (B, N, H, D)
    qkv, bias = attention_inputs(1024, 192, 8)
    q, k, v = (t.contiguous() for t in fa.split_qkv(qkv, heads))
    got = fa.attention_bnhd(q, k, v, bias)
    want = fa.attention_bnhd_ref(q, k, v, bias)
    err = rel_err(got, want)
    require(err <= TOL_K7, f"K8 differs from plain: {err} > {TOL_K7}")
    ms = cuda_ms(lambda: fa.attention_bnhd(q, k, v, bias))
    plain_ms = cuda_ms(lambda: fa.attention_bnhd_ref(q, k, v, bias), reps=2)
    lib_ms = attention_library_ms(*(t.permute(0, 2, 1, 3).contiguous()
                                    for t in (q, k, v)), bias)
    b8 = attention_work(1024, 192)
    print(f"K8 attention_bnhd B=1024 N=192 H={heads} D=64: rel err {err:.3e} "
          f"(tol {TOL_K7}); {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA "
          f"{lib_ms:.4f} ms, bound {b8['bound_ms']:.4f} ms ({b8['bound_by']})")
    k8 = dict(max_abs_err=abs_err(got, want), ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, **b8)
    del qkv, bias, q, k, v, got, want
    torch.cuda.empty_cache()

    # the block kernels and K6 at the new lengths
    for n in (193, 49, 13):
        x, plist, _ = block_inputs(1024, n, 1, dev, seed=n + 3)
        aerr, errs = check_block(f"fused_block (B=1024, N={n})",
                                 fb.fused_block(x, plist[0], heads),
                                 fb.block_ref(x, plist[0], heads), x,
                                 TOL_BLOCK, TOL_BLOCK_RMS)
        ms = cuda_ms(lambda: fb.fused_block(x, plist[0], heads))
        print(f"K2 fused_block B=1024 N={n}: {errs}; {ms:.3f} ms")
        del x, plist
    for n, depth in ((193, 1), (49, 4), (13, 2)):
        x, plist, _ = block_inputs(1024, n, depth, dev, seed=n + 4)
        qps = [fb.quantize_block_params(p) for p in plist]
        if depth == 1:
            run = lambda: fb.fused_block_q8(x, qps[0], heads)
            plain = lambda: fb.block_ref_q8(x, qps[0], heads)
            tol, tol_rms = TOL_BLOCK, TOL_BLOCK_RMS
        else:
            run = lambda: fb.fused_block_chain_q8(x, qps, heads)
            plain = lambda: fb.chain_ref_q8(x, qps, heads)
            tol, tol_rms = TOL_CHAIN, TOL_CHAIN_RMS
        aerr, errs = check_block(f"K4 (B=1024, N={n}, depth {depth})", run(),
                                 plain(), x, tol, tol_rms)
        ms = cuda_ms(run)
        print(f"K4 B=1024 N={n} depth {depth} dynamic: {errs}; {ms:.3f} ms")
        del x, plist, qps
        torch.cuda.empty_cache()
    for b, n in ((2 * TRAIN_PAIRS, 193), (2 * TRAIN_PAIRS, 49),
                 (2 * TRAIN_PAIRS, 13), (64, 256)):
        qkv, bias = attention_inputs(b, n, n + 9)
        out, probs = fa.attention_probs(qkv, bias, heads)
        want_out, want_probs = fa.attention_probs_ref(qkv, bias, heads)
        out_err, probs_err = rel_err(out, want_out), abs_err(probs, want_probs)
        require(out_err <= TOL_K6_OUT and probs_err <= TOL_K6_PROBS,
                f"K6 (B={b}, N={n}): out {out_err}, probs {probs_err}")
        ms = cuda_ms(lambda: fa.attention_probs(qkv, bias, heads))
        print(f"K6 attention_probs B={b} N={n}: out rel err {out_err:.3e}, "
              f"probs max |err| {probs_err:.3e}; {ms:.4f} ms")
        del qkv, bias, out, probs, want_out, want_probs
        torch.cuda.empty_cache()
    return {"attention_qkv": results[("K7", 1024, 193)],
            "attention_bnhd": k8}


# the operators whose own kernels are matrix products (cuBLAS names its
# kernels in several families, so they are counted by operator)
PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def profile_slice(run_slice, top=8, label="slice", ops=0):
    """One profiled run of the slice (or of ``label``): the device's busy
    share (kernel time over wall time) and the kernels that take the most
    device time; with ``ops``, also the PyTorch operators whose own kernels
    take the most device time, and the matrix products' share.
    Returns the run's result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run_slice()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiled {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms (share {busy_ms / wall_ms:.3f}) over {len(kernels)} kernels")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:8.2f} ms {ms / busy_ms:6.1%} x{e.count:<4d} "
              f"{e.key[:70]}")
    busy_ms = max(busy_ms, 1e-9)
    if ops:
        by_op = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CPU
                 and e.self_device_time_total > 0]
        by_op.sort(key=lambda e: e.self_device_time_total, reverse=True)
        mm_ms = sum(e.self_device_time_total for e in by_op
                    if e.key in PRODUCT_OPS) / 1e3
        print(f"  matrix products ({', '.join(PRODUCT_OPS)}): {mm_ms:.2f} ms "
              f"({mm_ms / busy_ms:.1%} of busy); by operator:")
        for e in by_op[:ops]:
            ms = e.self_device_time_total / 1e3
            print(f"  {ms:8.2f} ms {ms / busy_ms:6.1%} x{e.count:<5d} "
                  f"{e.key[:60]}")
    return out


def counters():
    """Every kernel wrapper, by the name its launch count goes under."""
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    return {"window_gather": wg.gather_windows,
            "fused_block": fb.fused_block,
            "fused_block_chain": fb.fused_block_chain,
            "fused_block_q8": fb.fused_block_q8,
            "fused_block_chain_q8": fb.fused_block_chain_q8,
            "fused_attention_train": fa.attention_probs,
            "attention_qkv": fa.attention_qkv,
            "attention_bnhd": fa.attention_bnhd}


def counted(run):
    """``run()`` with every launch count set to 0 just before it; returns
    its result and the counts read just after it."""
    fns = counters()
    for f in fns.values():
        f.launches = 0
    out = run()
    return out, {k: f.launches for k, f in fns.items()}


def require_launches(launches, wanted, unwanted, what):
    for k in wanted:
        require(launches[k] > 0, f"kernel {k} was not launched on {what}")
    for k in unwanted:
        require(launches[k] == 0, f"kernel {k} ran on {what}: {launches}")


def plain_versions():
    """A context in which the main path looks up every kernel wrapper's
    plain version instead (where the path looks them up)."""
    from deepmerge_tpu_torch.models import s2former
    from deepmerge_tpu_torch.ops import patches
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    def gather_ref(*args, trusted_origins=False):
        return wg.gather_windows_ref(*args)

    stack = contextlib.ExitStack()
    for module, attr, ref in (
            (patches, "gather_windows", gather_ref),
            (fa, "attention_probs", fa.attention_probs_ref),
            (fa, "attention_qkv", fa.attention_qkv_ref),
            (fa, "attention_bnhd", fa.attention_bnhd_ref),
            (s2former, "fused_block", fb.block_ref),
            (s2former, "fused_block_chain", fb.chain_ref),
            (s2former, "fused_block_q8", fb.block_ref_q8),
            (s2former, "fused_block_chain_q8", fb.chain_ref_q8)):
        stack.enter_context(mock.patch.object(module, attr, ref))
    return stack


def check_slice_outputs(out, r, n_edges, valid, labels_hw):
    """Finite ``simi`` of the right shape, min-member labels over the
    bucketed region axis, and a label map whose ids run 0..k-1."""
    import numpy as np

    from deepmerge_tpu_torch.infer.extract import region_bucket

    simi, labels, rounds, label_map, n_clusters = out
    simi_h, labels_h = simi.cpu().numpy(), labels.cpu().numpy()
    map_h = label_map.cpu().numpy()
    k_clusters, n_rounds = int(n_clusters), int(rounds)
    require(simi_h.shape == valid.shape, f"simi shape {simi_h.shape}")
    require(np.isfinite(simi_h[valid]).all(), "non-finite simi on real edges")
    require(np.isinf(simi_h[~valid]).all(), "pad edges must score +inf")
    r_pad = region_bucket(r)
    require(labels_h.shape == (r_pad,)
            and (labels_h <= np.arange(r_pad)).all(),
            "labels must be min-member ids over the region axis")
    require(map_h.shape == labels_hw, f"label map {map_h.shape}")
    require(1 <= k_clusters <= r and map_h.min() == 0
            and map_h.max() < k_clusters,
            f"n_clusters {k_clusters} vs label map max {map_h.max()}")
    require(0 <= n_rounds <= 8, f"rounds {n_rounds}")
    return map_h, k_clusters, n_rounds


def time_slice(run_slice, label, card):
    times = []
    for _ in range(3):
        t = time.perf_counter()
        run_slice()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    mpix = SCENE["h"] * SCENE["w"] / 1e6 / med
    print(f"slice ({label}, kernels): median {med * 1e3:.1f} ms of "
          f"{[round(x * 1e3, 1) for x in times]} ms -> {mpix:.3f} MPix/s on "
          f"{card}")


def rms_rel_err(got, want):
    got, want = got.float(), want.float()
    return float(((got - want) ** 2).mean().sqrt() / (want ** 2).mean().sqrt())


def first_round_flips(simi_k, simi_p, valid):
    """The share of real edges whose first merge decision differs: simi
    below the slice's threshold (the floor-index median of the real edges'
    simi) for one run and not for the other."""
    import numpy as np

    def below(simi):
        s = simi.cpu().numpy()[valid]
        return s < np.quantile(s, 0.5, method="lower")

    return float((below(simi_k) != below(simi_p)).mean())


def against_plain(run_slice, embed, out_k, valid, label):
    """The same slice with the plain versions on the card: the embeddings'
    RMS error and the share of first-round merge decisions that differ are
    held to their bounds; the label disagreement of the merged maps is
    printed (see ``TOL_EMB_RMS``). ``embed()`` gives the scene's
    embeddings, ``out_k`` is the kernels' run of the slice."""
    from deepmerge_tpu_torch.utils.parity import label_disagreement

    emb_k = embed()
    with plain_versions():
        t = time.perf_counter()
        simi_p, _, rounds_p, map_p, n_p = run_slice()
        plain_s = time.perf_counter() - t
        emb_p = embed()
    emb_rms = rms_rel_err(emb_k, emb_p)
    flips = first_round_flips(out_k[0], simi_p, valid)
    dis = label_disagreement(out_k[3].cpu().numpy(), map_p.cpu().numpy())
    print(f"slice ({label}, plain versions): {plain_s * 1e3:.1f} ms, "
          f"{int(n_p)} clusters after {int(rounds_p)} rounds; embeddings "
          f"RMS rel err {emb_rms:.3e} (max {TOL_EMB_RMS}); first-round merge "
          f"decisions that differ {flips:.5f} of {int(valid.sum())} edges "
          f"(max {EDGE_FLIPS_MAX}); label disagreement {dis:.5f} (parity "
          f"bar {LABEL_DISAGREEMENT_MAX}; random weights: printed, not "
          "gated)")
    require(emb_rms <= TOL_EMB_RMS,
            f"{label}: embeddings RMS rel err {emb_rms} > {TOL_EMB_RMS}")
    require(flips <= EDGE_FLIPS_MAX,
            f"{label}: {flips} of the merge decisions differ > "
            f"{EDGE_FLIPS_MAX}")


def export_folder(root, n_scenes):
    """``n_scenes`` serving scenes in the reference folder layout, each
    with its ``<name>_labels.npy`` superpixel sidecar; returns the image
    and shapefile folders and each scene's point and edge counts."""
    import numpy as np

    from deepmerge_tpu_torch.geodata.ingest import export_scene
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene

    images = os.path.join(root, "images")
    shps = os.path.join(root, "shps")
    stage = os.path.join(root, "stage")
    os.makedirs(images, exist_ok=True)
    counts = {}
    for seed in range(1, n_scenes + 1):
        scene = generate_scene(**SERVE_SCENE, seed=seed, name=f"scene{seed}")
        paths = export_scene(scene, stage, compression="deflate")
        os.rename(paths["image"], os.path.join(images, f"{scene.name}.tif"))
        os.makedirs(os.path.join(shps, scene.name), exist_ok=True)
        for ext in (".shp", ".shx", ".dbf"):
            os.rename(os.path.join(stage, f"{scene.name}{ext}"),
                      os.path.join(shps, f"{scene.name}{ext}"))
            for base in ("PointsGCS", "lines"):
                src = os.path.join(stage, scene.name, f"{base}{ext}")
                if os.path.exists(src):
                    os.rename(src, os.path.join(shps, scene.name,
                                                f"{base}{ext}"))
        np.save(os.path.join(shps, f"{scene.name}_labels.npy"), scene.labels)
        counts[scene.name] = (scene.regions.num_points, scene.rag.num_edges)
    return images, shps, counts


def serving_scene(cfg, ex, images, shps, name):
    """One walk scene again, on its own: ``process_scene`` as the walk
    calls it (the same batch, the fused serving path), profiled for the
    device's busy share, then on the plain versions: its embeddings and
    its first-round merge decisions held to theirs, the label disagreement
    of the merged maps printed."""
    import numpy as np

    from deepmerge_tpu_torch.geodata.ingest import load_scene
    from deepmerge_tpu_torch.utils.parity import label_disagreement
    from deepmerge_tpu_torch.infer.driver import prestage_scene, process_scene
    from deepmerge_tpu_torch.train.sampler import stage_scene

    scene = load_scene(
        os.path.join(images, f"{name}.tif"), os.path.join(shps, f"{name}.shp"),
        os.path.join(shps, name, "PointsGCS.shp"),
        os.path.join(shps, name, "lines.shp"), name=name,
        labels=np.load(os.path.join(shps, f"{name}_labels.npy")))
    ds = stage_scene(scene, cfg.data, ex.device)
    prestage_scene(ex, scene, ds, cfg.data, max(cfg.merge.edge_batch, 1))

    def run():
        return process_scene(cfg, scene, extractor=ex, device_scene=ds,
                             log_fn=lambda *_: None)

    print(f"serving scene {name} ({scene.regions.num_points} points, batch "
          f"{SERVE_BATCH}), profiled:")
    emb_k, simi_k, res_k = profile_slice(run)
    with plain_versions():
        t = time.perf_counter()
        emb_p, simi_p, res_p = run()
        plain_s = time.perf_counter() - t
    emb_rms = float(np.sqrt(((emb_k - emb_p) ** 2).mean() / (emb_p ** 2).mean()))
    thr = cfg.merge.threshold
    flips = float(((simi_k < thr) != (simi_p < thr)).mean())
    dis = label_disagreement(res_k.label_map(scene), res_p.label_map(scene))
    print(f"serving scene {name} (plain versions): {plain_s:.3f} s; "
          f"embeddings RMS rel err {emb_rms:.3e} (max {TOL_EMB_RMS}); "
          f"first-round merge decisions (simi < {thr}) that differ: "
          f"{flips:.5f} of {simi_p.size} edges (max {EDGE_FLIPS_MAX}); "
          f"{res_k.num_clusters} vs {res_p.num_clusters} clusters, label "
          "disagreement "
          f"{dis:.5f} (printed, not gated: the walk's merge amplifies them)")
    require(emb_rms <= TOL_EMB_RMS, f"serving scene {name}: embeddings "
            f"RMS rel err {emb_rms} > {TOL_EMB_RMS}")
    require(flips <= EDGE_FLIPS_MAX, f"serving scene {name}: {flips} of the "
            f"merge decisions differ > {EDGE_FLIPS_MAX}")


def serving_walk(model, dev, card):
    """Phase 6: ``process_folder`` over the serving scenes; returns the
    launch counts of the walk."""
    import tempfile

    import numpy as np

    from deepmerge_tpu_torch.config import Config, DataConfig, MergeConfig
    from deepmerge_tpu_torch.geodata.geotiff import read_geotiff
    from deepmerge_tpu_torch.geodata.shapefile import ShapefileTable
    from deepmerge_tpu_torch.infer import driver, extract

    cfg = Config(model=model.cfg,
                 data=DataConfig(max_window=512, eval_batch_size=SERVE_BATCH),
                 merge=MergeConfig(engine="device"))
    stores = {}  # scene name -> in-memory store, where h5py is missing

    def in_memory_store(path):
        store = extract.FeatureStore(None)
        stores[os.path.basename(os.path.dirname(path))] = store
        return store

    if extract.HAS_H5PY:
        print("h5py: available; each scene writes its .h5")
        store_patch = contextlib.nullcontext()
    else:
        print("h5py: missing on this machine; the walk keeps each scene's "
              "embeddings in an in-memory FeatureStore")
        store_patch = mock.patch.object(driver, "FeatureStore",
                                        in_memory_store)
    ex = extract.FeatureExtractor(model, batch_size=SERVE_BATCH, device=dev)
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        images, shps, counts = export_folder(root, SERVE_SCENES)
        print(f"serving folder: {SERVE_SCENES} scenes of {SERVE_SCENE} "
              f"({sum(c[0] for c in counts.values())} points) written in "
              f"{time.perf_counter() - t:.1f} s")
        stats, log = {}, []
        t0 = time.perf_counter()
        with store_patch:
            done, launches = counted(lambda: driver.process_folder(
                cfg, images, shps, log_fn=log.append, write_labelmaps=True,
                extractor=ex, stats=stats, device=dev))
        wall = time.perf_counter() - t0
        for line in log:
            if line.startswith(("  walk[", "  prefetch[", "FAILED")):
                print(line)
        print(f"walk launches: {launches}")
        require(done == sorted(counts), f"scenes done: {done} of "
                f"{sorted(counts)}")
        tag = cfg.model.name
        for name, (n_points, n_edges) in counts.items():
            simi = ShapefileTable.read(
                os.path.join(shps, name, "lines.shp")).get_field("simi")
            simi = np.asarray(simi, np.float64)
            require(simi.shape == (n_edges,) and np.isfinite(simi).all(),
                    f"{name}: simi {simi.shape} finite "
                    f"{np.isfinite(simi).mean()}")
            tif = read_geotiff(os.path.join(shps, name, f"{tag}_merged.tif"))
            require(tif.array.shape[:2] == (SERVE_SCENE["h"], SERVE_SCENE["w"]),
                    f"{name}: merged map {tif.array.shape}")
            rows = (extract.FeatureStore.open(
                os.path.join(shps, name, f"{tag}_features.h5")).shape[0]
                if extract.HAS_H5PY else stores[name].read_all().shape[0])
            require(rows == n_points, f"{name}: {rows} rows for "
                    f"{n_points} points")
        serving_scene(cfg, ex, images, shps, sorted(counts)[0])
    ts = stats["scene_done_ts"]
    per_scene = [ts[0] - t0] + [b - a for a, b in zip(ts, ts[1:])]
    steady = statistics.median(per_scene[1:])
    mpix = SERVE_SCENE["h"] * SERVE_SCENE["w"] / 1e6
    print(f"serving walk: {len(done)}/{SERVE_SCENES} scenes in {wall:.3f} s; "
          f"per scene {[round(x, 3) for x in per_scene]} s; steady "
          f"{steady:.3f} s/scene -> {mpix / steady:.3f} MPix/s "
          f"(whole walk {SERVE_SCENES * mpix / wall:.3f} MPix/s) on {card}")
    return launches


def training_phase(dev, card, mcfg, label, aux_weights=(0.0, 0.0)):
    """Phase 7 for ``mcfg``: ``train.driver.train`` (see the module
    docstring), the aux heads' BatchNorm statistics checked to move for v4
    and v5. Returns the launch counts of the training run."""
    import tempfile

    import numpy as np
    import torch

    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.config import Config, DataConfig, TrainConfig
    from deepmerge_tpu_torch.geodata.synthetic import (
        generate_scene,
        make_training_pairs,
    )
    from deepmerge_tpu_torch.models.s2former import training_model
    from deepmerge_tpu_torch.train import checkpoint, loop
    from deepmerge_tpu_torch.train.driver import train
    from deepmerge_tpu_torch.train.sampler import FusedPairSampler

    scene = generate_scene(**SCENE)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = Config(
        model=mcfg,  # bf16 compute, f32 parameters
        data=DataConfig(batch_size=TRAIN_PAIRS, max_window=512),
        train=TrainConfig(num_epochs=TRAIN_EPOCHS, checkpoint_every=1,
                          checkpoint_dir=os.path.join(root, "ck"),
                          log_dir=os.path.join(root, "logs"),
                          aux_weights=aux_weights))
    bn = [f"aux{i}.aux.1.running_{k}" for i in (0, 1) for k in ("mean", "var")
          if mcfg.variant in ("v4", "v5")]
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    blocks = sum(cfg.model.depth)
    try:
        log = []
        t = time.perf_counter()
        (state, history), launches = counted(lambda: train(
            cfg, scene=scene, max_steps_per_epoch=TRAIN_STEPS,
            log_fn=log.append, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for line in log:
            print(f"  {line}")
        print(f"training ({label}): {steps} steps of {TRAIN_PAIRS} pairs in "
              f"{wall:.1f} s (first steps, checkpoints and loss files "
              f"included); launches {launches}")
        require(state.step == steps, f"trained {state.step} of {steps} steps")
        require(launches["fused_attention_train"] == blocks * steps,
                f"K6 launched {launches['fused_attention_train']} times, "
                f"want {blocks} a step")
        require_launches(launches, ("window_gather", "fused_attention_train"),
                         ("fused_block", "fused_block_chain", "fused_block_q8",
                          "fused_block_chain_q8", "attention_qkv",
                          "attention_bnhd"),
                         "the training run")
        losses = np.asarray(history.train_losses)
        require(losses.shape == (TRAIN_EPOCHS,) and np.isfinite(losses).all(),
                f"epoch losses {losses}")
        start_sd = init_state_dict(training_model(cfg), seed=cfg.train.seed)
        trained = state.model.state_dict()
        for k in bn:  # flax's initial statistics are zeros and ones
            moved = float((trained[k].cpu() - start_sd[k]).abs().max())
            require(moved > 0, f"BatchNorm buffer {k} did not move")
            print(f"  {k}: moved by up to {moved:.4f} from its start")

        # the last checkpoint restores the parameters and Adam's moments
        pos, neg = make_training_pairs(scene)
        sampler = FusedPairSampler(scene, pos, neg, cfg.data, dev)
        spe = len(sampler) // TRAIN_PAIRS
        mgr = checkpoint.CheckpointManager(cfg.train.checkpoint_dir, cfg)
        fresh = loop.create_train_state(cfg, spe, device=dev)
        fresh, start, _ = mgr.restore(fresh)
        require(start == TRAIN_EPOCHS and fresh.step == steps,
                f"restored epoch {start}, step {fresh.step}")
        for (k, a), b in zip(state.model.state_dict().items(),
                             fresh.model.state_dict().values()):
            require(torch.equal(a, b), f"restored {k} differs")
        moments = lambda st: [t for v in st.optimizer.state.values()
                              for t in (v["exp_avg"], v["exp_avg_sq"])]
        require(len(moments(state)) == len(moments(fresh)) > 0
                and all(torch.equal(a, b) for a, b in
                        zip(moments(state), moments(fresh))),
                "restored Adam moments differ")
        print(f"checkpoint: {os.path.basename(mgr.latest_path())} restores "
              f"{len(fresh.model.state_dict())} tensors and "
              f"{len(moments(fresh))} Adam moments exactly")
        del fresh
        torch.cuda.empty_cache()

        # step time: single steps after a warm-up step, each synchronized;
        # then eight steps as one scanned epoch, synchronized once
        epoch_fn = loop.make_scanned_epoch(cfg, sampler.device_scene)
        arrays = sampler.epoch_arrays(12345, TRAIN_PAIRS)
        step_arrays = lambda i, k=1: tuple(a[i : i + k] for a in arrays)
        epoch_fn(state, *step_arrays(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(1, 7):
            t = time.perf_counter()
            epoch_fn(state, *step_arrays(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated(dev)
        med = statistics.median(times)
        t = time.perf_counter()
        epoch_fn(state, *step_arrays(7, 8))
        torch.cuda.synchronize()
        scanned = (time.perf_counter() - t) / 8
        print(f"training step ({label}, {TRAIN_PAIRS} pairs, forward batch "
              f"{2 * TRAIN_PAIRS}): median {med * 1e3:.1f} ms of "
              f"{[round(x * 1e3, 1) for x in times]} ms -> "
              f"{TRAIN_PAIRS / med:.1f} pairs/s; scanned epoch of 8 steps "
              f"{scanned * 1e3:.1f} ms/step -> {TRAIN_PAIRS / scanned:.1f} "
              f"pairs/s; peak memory {peak / 2**30:.2f} GiB on {card}")
        profile_slice(lambda: (epoch_fn(state, *step_arrays(15)),
                               torch.cuda.synchronize()),
                      top=10, label=f"training step ({label})", ops=16)

        # four steps from the same weights and batches on the plain
        # versions, their dropout masks from the same seeded generator
        first = sampler.epoch_arrays(cfg.train.seed * 100003 % 2**32,
                                     TRAIN_PAIRS)
        first = tuple(a[:4] for a in first)

        def four_steps():
            st = loop.create_train_state(cfg, spe, state_dict=start_sd,
                                         device=dev)
            _, out = epoch_fn(st, *first)
            return out.cpu().numpy().astype(np.float64)

        del state
        torch.cuda.empty_cache()
        got = four_steps()
        with plain_versions():
            t = time.perf_counter()
            want = four_steps()
            plain_s = time.perf_counter() - t
        rel = np.abs(got - want) / np.abs(want)
        print(f"training ({label}) on the plain versions ({plain_s:.1f} s "
              "for 4 steps):"
              f" losses {want.tolist()}, kernels {got.tolist()}, rel diff "
              f"{rel.tolist()} (step 0 max {TOL_TRAIN_LOSS0}, all max "
              f"{TOL_TRAIN_LOSS})")
        require(np.isfinite(got).all() and rel[0] <= TOL_TRAIN_LOSS0
                and rel.max() <= TOL_TRAIN_LOSS,
                f"training losses differ from the plain versions': {rel}")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "deepmerge_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)

    import warnings

    import numpy as np

    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.utils.parity import label_disagreement
    from deepmerge_tpu_torch import DataConfig, ModelConfig
    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.models import s2former
    from deepmerge_tpu_torch.ops.kernels import build
    from deepmerge_tpu_torch.train.sampler import stage_scene

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)

    # 1. the card
    card = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader", "-i", "0"])
    print(card)  # name, power limit
    nvcc = run_cmd([build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc}, python {sys.version.split()[0]}")

    # 2. the build, one nvcc per source, in parallel
    sources = ("window_gather", "fused_block", "fused_block_q8",
               "fused_attention")
    t = time.perf_counter()
    build.build_all(sources)
    print(f"build: {', '.join(k + '.cu' for k in sources)} in "
          f"{time.perf_counter() - t:.1f} s -> {build.BUILD_DIR}")
    for k, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{k}]: {line.strip()}")

    # the scene of the slices (also the gather check's input)
    dcfg = DataConfig(max_window=512, eval_batch_size=1024)
    t = time.perf_counter()
    scene = generate_scene(**SCENE)
    r = scene.regions.num_regions
    edges = scene.rag.edges.astype(np.int32)
    n_edges = len(edges)
    pad = (-n_edges) % 2048
    edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    valid = np.arange(len(edges)) < n_edges
    ds = stage_scene(scene, dcfg, dev)
    edges_d = torch.from_numpy(edges).to(dev)
    valid_d = torch.from_numpy(valid).to(dev)
    region_map = torch.from_numpy(scene.labels).to(dev)
    print(f"scene: {SCENE['h']}x{SCENE['w']}, {scene.regions.num_points} "
          f"points, {n_edges} edges, caps {ds.caps}, set up in "
          f"{time.perf_counter() - t:.1f} s")

    # 3. kernels against their plain versions
    kernel_results = check_kernels(dev, ds, scene)
    kernel_results.update(check_k4(dev))
    kernel_results.update(check_k6(dev))
    kernel_results.update(check_wide_tokens(dev))

    def extractor_for(quantize, **model_kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # w8a8-static's experiment note
            # the flagship v3 unless model_kw says otherwise, bf16
            mcfg = ModelConfig(quantize=quantize, **model_kw)
        model = s2former.S2Former(mcfg)
        model.load_state_dict(init_state_dict(mcfg, seed=0), strict=True)
        return FeatureExtractor(model, batch_size=dcfg.eval_batch_size,
                                device=dev)

    def slice_runner(extractor):
        def run_slice():
            out = extractor.segment_scene_device(
                scene, dcfg, edges_d, valid_d, num_regions=r, max_rounds=8,
                device_scene=ds, region_map=region_map,
            )
            torch.cuda.synchronize()
            return out
        return run_slice

    def embedder(extractor):
        return lambda: extractor.extract_scene_device(scene, dcfg,
                                                      device_scene=ds)

    bf16_kernels = ("window_gather", "fused_block", "fused_block_chain")
    q8_kernels = ("window_gather", "fused_block_q8", "fused_block_chain_q8")
    block_kernels = bf16_kernels[1:] + q8_kernels[1:]
    attention = ("attention_qkv", "attention_bnhd")  # K7, K8

    # 4. the bf16 slice
    ex_bf16 = extractor_for("")
    run_bf16 = slice_runner(ex_bf16)
    t = time.perf_counter()
    out, launches = counted(run_bf16)
    print(f"slice (bf16) launches: {launches} (first run "
          f"{time.perf_counter() - t:.3f} s)")
    require_launches(launches, bf16_kernels, q8_kernels[1:] + attention,
                     "the bf16 slice")
    map_bf16, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                                scene.labels.shape)
    print(f"slice (bf16): {k} clusters after {n_rounds} rounds")
    time_slice(run_bf16, "bf16", card)
    profile_slice(run_bf16)
    against_plain(run_bf16, embedder(ex_bf16), out, valid, "bf16")
    del ex_bf16, run_bf16
    torch.cuda.empty_cache()
    all_launches = dict(launches)
    path_runs = [launches]  # every main-path run's counts, for K8's

    # 5. the w8a8 slice, then one w8a8-static run
    ex_q8 = extractor_for("w8a8")
    run_q8 = slice_runner(ex_q8)
    t = time.perf_counter()
    out, launches = counted(run_q8)
    print(f"slice (w8a8) launches: {launches} (first run "
          f"{time.perf_counter() - t:.3f} s)")
    require_launches(launches, q8_kernels, bf16_kernels[1:] + attention,
                     "the w8a8 slice")
    map_q8, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                              scene.labels.shape)
    print(f"slice (w8a8): {k} clusters after {n_rounds} rounds; label "
          f"disagreement with the bf16 slice {label_disagreement(map_bf16, map_q8):.5f} "
          "(random weights: printed, not gated)")
    time_slice(run_q8, "w8a8", card)
    profile_slice(run_q8)
    against_plain(run_q8, embedder(ex_q8), out, valid, "w8a8")
    all_launches.update({k: launches[k] for k in q8_kernels[1:]})
    path_runs.append(launches)

    ex_static = extractor_for("w8a8-static")
    require(ex_static.needs_calibration, "w8a8-static starts uncalibrated")
    run_static = slice_runner(ex_static)
    t = time.perf_counter()
    out, launches = counted(run_static)
    print(f"slice (w8a8-static) launches: {launches}, calibrated on the "
          f"first chunk ({time.perf_counter() - t:.3f} s with calibration)")
    require(not ex_static.needs_calibration, "w8a8-static did not calibrate")
    require_launches(launches, q8_kernels, bf16_kernels[1:] + attention,
                     "the w8a8-static slice")
    path_runs.append(launches)
    _, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                         scene.labels.shape)
    print(f"slice (w8a8-static): {k} clusters after {n_rounds} rounds")
    against_plain(run_static, embedder(ex_static), out, valid,
                  "w8a8-static")
    del ex_static, run_static
    torch.cuda.empty_cache()

    # 5b. v5 (the designed-feature token in the sequence: N = 193/49/13)
    # served in w8a8 through K4, then at the reference's erf GELU, whose
    # blocks leave the block kernels: K7 in each, no block kernel
    v5_chunks = -(-scene.regions.num_points // dcfg.eval_batch_size)
    v5_blocks = sum(ModelConfig().depth)
    for label, quantize, kw, on, off in (
            ("v5 w8a8", "w8a8", dict(variant="v5"), q8_kernels,
             bf16_kernels[1:] + attention),
            ("v5 exact_gelu", "", dict(variant="v5", exact_gelu=True),
             ("window_gather", "attention_qkv"),
             block_kernels + ("attention_bnhd",))):
        ex = extractor_for(quantize, **kw)
        run = slice_runner(ex)
        t = time.perf_counter()
        out, launches = counted(run)
        print(f"slice ({label}) launches: {launches} (first run "
              f"{time.perf_counter() - t:.3f} s)")
        require_launches(launches, on, off, f"the {label} slice")
        path_runs.append(launches)
        if "attention_qkv" in on:
            require(launches["attention_qkv"] == v5_blocks * v5_chunks,
                    f"K7 launched {launches['attention_qkv']} times, want "
                    f"{v5_blocks} a chunk")
            all_launches["attention_qkv"] = launches["attention_qkv"]
        _, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                         scene.labels.shape)
        print(f"slice ({label}): {k} clusters after {n_rounds} rounds")
        time_slice(run, label, card)
        profile_slice(run, label=f"slice ({label})", ops=8)
        against_plain(run, embedder(ex), out, valid, label)
        del ex, run
        torch.cuda.empty_cache()

    # 6. the serving walk
    launches = serving_walk(ex_q8.model, dev, card)
    require_launches(launches, q8_kernels, bf16_kernels[1:] + attention,
                     "the serving walk")
    path_runs.append(launches)
    del ex_q8, run_q8
    torch.cuda.empty_cache()

    # 7. training: the flagship, then v5 with its aux losses
    launches = training_phase(dev, card, ModelConfig(), "v3")
    all_launches["fused_attention_train"] = launches["fused_attention_train"]
    path_runs.append(launches)
    path_runs.append(training_phase(dev, card, ModelConfig(variant="v5"),
                                    "v5", aux_weights=(0.1, 0.2)))
    # no model path runs K8: each run above required its count to be 0
    all_launches["attention_bnhd"] = sum(l["attention_bnhd"]
                                         for l in path_runs)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    sources = {
        "window_gather": ("deepmerge_tpu_torch/csrc/window_gather.cu",
                          "deepmerge_tpu/ops/pallas/window_gather.py:37"),
        "fused_block": ("deepmerge_tpu_torch/csrc/fused_block.cu",
                        "deepmerge_tpu/ops/pallas/fused_block.py:375"),
        "fused_block_chain": ("deepmerge_tpu_torch/csrc/fused_block.cu",
                              "deepmerge_tpu/ops/pallas/fused_block.py:401"),
        "fused_block_q8": ("deepmerge_tpu_torch/csrc/fused_block_q8.cu",
                           "deepmerge_tpu/ops/pallas/fused_block.py:385"),
        "fused_block_chain_q8": (
            "deepmerge_tpu_torch/csrc/fused_block_q8.cu",
            "deepmerge_tpu/ops/pallas/fused_block.py:401"),
        "fused_attention_train": (
            "deepmerge_tpu_torch/csrc/fused_attention.cu",
            "deepmerge_tpu/ops/pallas/fused_attention.py:311"),
        "attention_qkv": ("deepmerge_tpu_torch/csrc/fused_attention.cu",
                          "deepmerge_tpu/ops/pallas/fused_attention.py:143"),
        "attention_bnhd": ("deepmerge_tpu_torch/csrc/fused_attention.cu",
                           "deepmerge_tpu/ops/pallas/fused_attention.py:26"),
    }
    kernels = [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=all_launches[k], **kernel_results[k])
        for k, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
