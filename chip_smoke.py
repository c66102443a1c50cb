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
     also at the serving walk's batch of 2048; the int8 attention core of
     ``w8a8+attn`` (K4a) in the w8a8 block and chain, dynamic and static, at
     the slice's batch of 1024 and N = 192/48/12 and 193/49/13, each time
     beside K4's at the same shape; the saved-activation training block
     (K5) at the training batch of 240 and the same lengths, its output,
     its four saved residuals and the gradients of x and of every
     parameter through its autograd function; K2 and K3 beside one
     ``torch.nn.TransformerEncoderLayer`` / ``TransformerEncoder``; K2's
     GEMM alone on a stage-0 block's four shapes (TFLOP/s beside
     ``torch.matmul``), K4's s8 GEMM alone on the same shapes (bit-exact
     epilogues, s32 sums equal to ``torch._int_mm``'s, TOP/s beside
     ``torch._int_mm`` and the bf16 GEMM), K4a's int8
     core alone beside the bf16 core, and K7 under other launch plans of
     its core; K1, the fused patch kernel (``patch_resize``), bit-exact on
     every slot of the slice's points and of the first walk scene's, at a
     cap of 256 and on scenes of 1, 3, 4 and 5 bands, in bf16 and float32,
     each slice slot timed (median of 20 launches) beside its plain version
     and the unfused stage it replaced (K1's gather and two float32
     products); K1's gather, which the float path keeps, bit-exact and
     timed with trusted origins; K9, the label-map lookup that expands
     every slice's merged map, bit-exact on the slice's 1024² map (R 2048)
     and a random 2048² one (R 8192), ids out of range included, timed by
     device time beside ``dense[map.long()]``; K10, the int4 dot probe,
     each variant (s8 x s8, s4 x s4, s8 x widened s4) bit-exact at M 4096,
     K 768, N 3072, its TOP/s beside ``torch._int_mm`` and K4's s8 GEMM
     (a refusal of the s4 ``mma`` by ptxas would be printed as the
     probe's answer);
  4. the bf16 slice: ``FeatureExtractor.segment_scene_device`` on a 1024²
     scene with 2043 sample points, every kernel's launch count over that
     run (K1's fused patch kernel 3 a chunk, its gather none), the median
     time of three runs, one profiled run (the device's busy share and its
     time by kernel), and the same slice with the plain
     versions on the card as the reference (the embeddings' RMS error and
     the share of first-round merge decisions that differ held to their
     bounds, the label disagreement of the maps printed: on random weights
     the merge amplifies a few edges, see ``TOL_EMB_RMS``);
  5. the same slice with ``quantize="w8a8"`` (K1 and K4 launched, K2 and K3
     not), checked the same way, its label disagreement with the bf16
     slice printed, and timed and profiled again with the patch stage
     unfused (``unfused_patch_stage``: with the gather's bounds check, and
     timed without it), then fused again; then the float
     path (``data.quantize_uint8=False``: K1's gather, no fused patch
     kernel) for the slice's embeddings; then one ``w8a8-static`` run,
     calibrated on its first chunk; then the same slice on v5 (the designed-feature token in the
     sequence, N = 193/49/13), in w8a8 (K1 and K4, not K2, K3, K7 or K8)
     and at the reference's erf GELU in bf16 (K1 and K7, 12 launches a
     chunk, no block kernel, no K8), each timed, profiled and held to the
     plain versions; and (5b) the v3 slice in ``w8a8+attn``: K1, then K4a in
     12 block and 4 chain launches, no K2, K3 or K4 without it, timed,
     profiled, held to the plain versions, its label disagreement with the
     w8a8 slice printed;
  6. the serving walk: ``process_folder`` with ``quantize="w8a8"`` and
     label maps over four 2048² scenes of 8192 regions in the reference
     folder layout (K1's fused patch kernel 3 a chunk), each scene's
     ``simi``, merged map and stored embeddings checked, and the
     steady-state MPix/s from the gaps between completions; then its first
     scene again through ``process_scene``, profiled (busy
     share), and on the plain versions (its embeddings and its first-round
     merge decisions held to theirs);
  7. training: ``train.driver.train`` on the flagship at 120 pairs a step
     (a forward batch of 240) for two epochs of eight steps on the 1024²
     scene, checkpointing every epoch: K6 launched 12 times a step and K1's
     fused patch kernel 3 times, no block kernel and no gather; finite
     losses; the last checkpoint restores the parameters and Adam's
     moments; the median step time, pairs/s,
     peak memory and one profiled step; and four steps from the same
     weights and batches on the plain versions, their losses held to the
     kernels'. Then the same for v5 with its aux losses at weights
     (0.1, 0.2): K6 12 times a step at N = 193/49/13, the aux
     heads' BatchNorm statistics moved and restored exactly, the plain
     versions' four steps drawing the same dropout masks. Then the flagship
     again with ``train.fused_block=True``: K5 launched 12 times a step,
     K6 not at all, timed and profiled beside the unfused run, its losses
     held to the plain versions' and its step-0 loss to the unfused run's
     on the same weights and batch;
  8. the parity bar on trained weights: the flagship trained on the
     slice's scene (``TRUSTED_EPOCHS`` epochs, about 120 s), an absolute
     threshold calibrated on a second scene, then the v3 bf16, w8a8 and
     w8a8+attn slices at that threshold on the kernels and on the plain
     versions, the merged maps' label disagreement gated at BASELINE.md's
     0.5%; the same for the first walk scene (2048², 8192 regions, w8a8)
     through ``process_scene`` and through ``segment_scene_device`` with
     its region map (K9 at 2048²), and for v5, trained and calibrated the
     same way, in a w8a8 slice;
  9. scale-out, on those trained weights and that threshold, the flagship
     in w8a8: world size 1 on NCCL in this process
     (``extract_and_merge_sharded``, ``process_scene(mesh=...)``, and
     ``process_folder(mesh=...)`` over the walk's scenes, each partition
     gated at 0.5% against the single-device one on the same kernels, K1
     and K4 launched and no other kernel, times beside the single-device
     paths), then two ranks in two processes on the one card over gloo
     (the sharded run on two strips and ``process_scene(mesh=...)`` gated
     the same way, each rank's strip tile and peak memory, four steps of
     the data-parallel trainer held to one device's losses, the parameters
     equal on both ranks); then tensor parallelism, two ranks on the one
     card over gloo (n_model 2: the flagship's 12 heads, 6 of width 64 a
     rank, through K7 and in training K6): the slice's embeddings held to
     the single-device plain forward (RMS error, first-round decisions at
     phase 8's threshold), two training steps held to one device's losses,
     the replicated parameters equal on both ranks;
 10. the modules ported last: K1 at the vit sides (the fused patch kernel
     bit-exact at out 28/56/112/224 on the vit slice's caps and at a cap of
     256, its gather at the caps above 256 and at 512, each fused slot
     timed); the vit slice at ViT-B width (``variant="vit"``: embed 768,
     12 blocks, 12 heads, 198 tokens, bf16) through
     ``segment_scene_device`` (K1 launched, no other kernel: the vit's
     blocks are plain PyTorch), timed, profiled with the attention core's
     share of device time, held to the plain versions, then on the float
     path (K1's gather alone); vit training (``train()``, 4 steps of 120
     pairs, step time and peak memory, four steps held to the plain
     versions by phase 7's bars); ``model.quantize=w8a8`` with vit warning
     and serving the bf16 embeddings; the legacy harness (``train_mlp``,
     ``train_gru``), one ``TripletSampler`` batch at crop 224 through
     ``SpatiallyMemorizedNetwork`` and ``triplet_loss``, and
     ``export_class_patches`` at window 224 read back with
     ``load_patch_shard``, their patches bit-exact against the plain path;
     ``python -m deepmerge_tpu_torch.eval --calibrate`` as a subprocess on
     the card; ``utils.profiling``'s ``sync_time`` and ``rep_probe`` of one
     K4 block beside CUDA events.

``--only patches,kernels,trained,scaleout,family`` runs K1's fused patch
check, phase 3, phase 8, phases 8 and 9 and/or phase 10 alone (after the
card, the build and the scene) and prints no result lines: a development
run, not the smoke run.

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
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The fused patch kernel takes the plain version's weights: its row pass
# is integer-exact and its column pass sums the same float32 products,
# which the rounding to uint8 steps absorbs, so it is held bit-exact too.
TOL_GATHER = 0.0
TOL_PATCHES = 0.0
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
# K5 (the training block): its output and its residual r as a block's
# (TOL_BLOCK, TOL_BLOCK_RMS), its probabilities as K6's, its saved qkv and
# pre-GELU activation (bf16 roundings of the same sums) within 2e-2 of
# max|plain|, and the gradients of x and of every parameter through the
# autograd function, kernel forward against plain forward (the backward is
# the same torch code on the residuals each forward saved), within 2e-2 of
# their max, as K6's.
TOL_K5_SAVED = 2e-2
TOL_K5_GRAD = 2e-2
# The training block against the unfused blocks: the same function with
# other rounding points (the probabilities normalized before the value
# product, the two-pass LayerNorm, the pre-GELU activation in float32), so
# their step-0 losses on the same weights and batch differ by roundings.
TOL_K5_VS_UNFUSED_LOSS0 = 1e-2
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
# the trained-weight parity phase: whole epochs (49 steps of TRAIN_PAIRS on
# the slice's scene), about 120 s of card time at 165-182 ms a step
TRUSTED_EPOCHS = 14


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


def demangle(names):
    """C++ names of mangled kernel symbols (c++filt where the machine has
    it), without the anonymous namespace and the parameter list."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        plain = out.stdout.splitlines()
    except (OSError, subprocess.TimeoutExpired):
        plain = []
    if len(plain) != len(names):
        plain = names
    strip = lambda n: n.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ")
    return [strip(n) for n in plain]


def ptxas_summary(log):
    """(kernel, registers, spill line) for each entry function in an nvcc
    ``-Xptxas -v`` log, in the order ptxas compiled them."""
    import re

    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append((name, int(regs), spill))
            name = None
    return [(n, r, sp) for n, (_, r, sp) in
            zip(demangle([row[0] for row in rows]), rows)]


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


def cuda_median_ms(fn, reps=20):
    """Median device time of one call of ``fn`` over ``reps`` calls, each
    between its own pair of CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def kernel_ms(fn, reps=20):
    """Device time of one call of ``fn``: the time of the CUDA kernels it
    launches, under the profiler over ``reps`` calls after one warm-up,
    over ``reps``. Unlike ``cuda_ms``, no host gap between launches counts:
    for a kernel of a few microseconds the host's launch path is longer
    than the kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return us / 1e3 / reps


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


def block_work(b, n, depth, q8=False, q8_attn=False, c=768, heads=12,
               hidden=3072):
    """(bytes, bf16 FLOPs, int8 ops) of ``depth`` blocks run back to back
    on a (b, n, c) bf16 activation: the activation read and the output
    written once, each block's weights (int8 with f32 scales when ``q8``),
    biases, LayerNorm parameters and f32 attention bias read once; the four
    GEMMs (int8 when ``q8``) and the attention's q·kᵀ and p·v in bf16 (int8
    with ``q8_attn``)."""
    m = b * n
    weights = 4 * c * c + 2 * c * hidden
    per_block = (weights * (1 if q8 else 2) + (4 * c + hidden) * 2
                 + 4 * c * 4 + heads * n * n * 4
                 + ((4 * c + hidden) * 4 if q8 else 0))
    nbytes = 2 * m * c * 2 + depth * per_block
    gemm = 2 * m * weights
    attn = 4 * b * n * n * c
    if q8_attn:
        return nbytes, 0.0, depth * (gemm + attn)
    if q8:
        return nbytes, depth * attn, depth * gemm
    return nbytes, depth * (gemm + attn), 0.0


def train_block_work(b, n, c=768, heads=12, hidden=3072):
    """K5's work: one block's (``block_work``) plus the residuals it
    writes, bf16 qkv (b, n, 3c), probabilities (b, heads, n, n), pre-GELU
    activation (b, n, hidden) and r (b, n, c)."""
    nbytes, flops, _ = block_work(b, n, 1, c=c, heads=heads, hidden=hidden)
    saved = 2 * b * n * (3 * c + heads * n + hidden + c)
    return nbytes + saved, flops, 0.0


def encoder_library_ms(x, depth, heads=12, hidden=3072):
    """The time of one PyTorch call computing ``depth`` pre-LN blocks on x
    (B, N, C) bf16 with an (H, N, N) attention bias: a
    ``torch.nn.TransformerEncoderLayer`` (norm first, batch first, tanh
    GELU, no dropout; a ``TransformerEncoder`` of ``depth`` of them) in
    bf16 eval, the bias as a float (B·H, N, N) mask built before the timed
    calls. The yardstick of K2 and K3 (the port never calls it); random
    weights, since only its time is read."""
    import torch
    import torch.nn.functional as F

    b, n, c = x.shape
    layer = torch.nn.TransformerEncoderLayer(
        c, heads, hidden, dropout=0.0,
        activation=lambda t: F.gelu(t, approximate="tanh"),
        batch_first=True, norm_first=True)
    model = (layer if depth == 1 else torch.nn.TransformerEncoder(
        layer, depth, enable_nested_tensor=False))
    model = model.to(x.device, x.dtype).eval()
    g = torch.Generator(device=x.device).manual_seed(0)
    mask = (torch.randn((b * heads, n, n), generator=g, device=x.device)
            * 0.5).to(x.dtype)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x, mask))
    del model, mask
    torch.cuda.empty_cache()
    return ms


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

    # K1's gather serves the float path (caps above 256, or no uint8
    # rounding): chunks of 256 points, every slot's window
    c = ds.padded.shape[-1]
    scene2d = ds.padded.reshape(ds.padded.shape[0], -1)
    pad = patches.scene_pad(ds.caps, c)
    a_px = wg.pixel_align(c)
    centers = torch.as_tensor(scene.regions.points_yx, dtype=torch.int32,
                              device=dev)
    worst, n_calls, last = 0.0, 0, None
    for slot, cap in enumerate(ds.caps):
        rows, cols = cap + wg.ROW_ALIGN, (cap + a_px) * c
        for s in range(0, centers.shape[0], 256):
            starts, _, _ = wg.window_starts(centers[s : s + 256], cap, pad, c)
            got = wg.gather_windows(scene2d, starts, rows, cols)
            want = wg.gather_windows_ref(scene2d, starts, rows, cols)
            worst = max(worst, abs_err(got, want))
            n_calls += 1
            if starts.shape[0] == 256:
                last = (starts, rows, cols)
    require(worst <= TOL_GATHER, f"window gather differs from plain: {worst}")
    starts, rows, cols = last
    # origins from window_starts of points inside the scene: aligned and in
    # bounds, so timed without the bounds check's host round trip
    ms = cuda_median_ms(lambda: wg.gather_windows(scene2d, starts, rows, cols,
                                                  trusted_origins=True))
    plain_ms = cuda_median_ms(lambda: wg.gather_windows_ref(
        scene2d, starts, rows, cols), reps=5)
    # the PyTorch call that computes the same gather: one advanced-indexing
    # read with the index grids already built
    ri = starts[:, 0:1].long() + torch.arange(rows, device=dev)
    ci = starts[:, 1:2].long() + torch.arange(cols, device=dev)
    library_ms = cuda_median_ms(
        lambda: scene2d[ri[:, :, None], ci[:, None, :]])
    b1 = bound(2 * starts.shape[0] * rows * cols + starts.numel() * 4)
    print(f"K1 window_gather (float path): {n_calls} calls (3 slots x "
          f"256-point chunks, windows {rows}x{cols} B), max |err| {worst} "
          f"(tol {TOL_GATHER}, bit-exact); 256 points, trusted origins, "
          f"median of 20: {ms:.4f} ms, plain {plain_ms:.4f} ms, indexing "
          f"call {library_ms:.4f} ms, bound {b1['bound_ms']:.4f} ms "
          f"({b1['bound_by']})")
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
        lib_ms = encoder_library_ms(x, 1)
        b2 = bound(*block_work(b, 192, 1))
        print(f"K2 fused_block B={b} N=192 C=768 H=12: {errs}; {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, TransformerEncoderLayer "
              f"{lib_ms:.3f} ms (target K2 <= it: {target(ms <= lib_ms)}), "
              f"bound {b2['bound_ms']:.3f} ms ({b2['bound_by']})")
        k2.append(dict(max_abs_err=aerr, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, **b2))
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
            lib_ms = encoder_library_ms(x, depth)
            print(f"K3 fused_block_chain B={b} N={n} depth {depth}: {errs}; "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"TransformerEncoder {lib_ms:.3f} ms")
            per_stage[(b, n)] = dict(max_abs_err=aerr, ms=ms,
                                     plain_ms=plain_ms, library_ms=lib_ms)
    # the JSON line reports the main path's chunk: both stages summed
    s1, s2 = per_stage[(1024, 48)], per_stage[(1024, 12)]
    b3 = bound(*add_work(block_work(1024, 48, 4), block_work(1024, 12, 2)))
    print(f"K3 at B=1024, both stages: bound {b3['bound_ms']:.3f} ms "
          f"({b3['bound_by']})")
    results["fused_block_chain"] = dict(
        max_abs_err=max(s1["max_abs_err"], s2["max_abs_err"]),
        ms=s1["ms"] + s2["ms"], plain_ms=s1["plain_ms"] + s2["plain_ms"],
        library_ms=s1["library_ms"] + s2["library_ms"], **b3,
    )
    return results


# the targets of the attention core's and the GEMM's redesign, printed as
# met or not beside the numbers they read
TARGET_GEMM_TFLOPS = 500.0
TARGET_K7_BOUND_FACTOR = 3.0


def unfused_slot(padded, centers, scales, cap, out, pad, out_channels=None,
                 out_dtype=None, trusted_origins=False, chunk=256):
    """One slot's exact patches as the port made them before the fused
    patch kernel, with ``patch_resize``'s signature: per 256-point chunk,
    K1's gather (with its bounds check's host sync unless the origins are
    trusted), the plain version's two float32 products and rounding chain,
    and a concatenation."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    c = padded.shape[-1]
    co = c if out_channels is None else out_channels
    scene2d = padded.reshape(padded.shape[0], -1)
    rows, cols = cap + wg.ROW_ALIGN, (cap + wg.pixel_align(c)) * c
    parts = []
    for i in range(0, centers.shape[0], chunk):
        starts, s, off_y, off_x = pr.slot_geometry(
            centers[i : i + chunk], scales[i : i + chunk], cap, pad, c)
        windows = wg.gather_windows(scene2d, starts, rows, cols,
                                    trusted_origins=trusted_origins)
        parts.append(pr.resize_windows_exact(
            windows, s, off_y, off_x, out, c,
            out_dtype or torch.float32)[..., :co])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unfused_patch_stage(bounds_check=True):
    """A context in which the main path's exact patch stage runs unfused
    (``unfused_slot``): with ``bounds_check``, with the gather's bounds
    check whatever the caller vouches for, as the port served it before
    the fused kernel; else with the caller's ``trusted_origins``."""
    from deepmerge_tpu_torch.ops import patches

    def stage(*args, trusted_origins=False, **kwargs):
        return unfused_slot(*args, trusted_origins=trusted_origins
                            and not bounds_check, **kwargs)

    return mock.patch.object(patches, "patch_resize", stage)


def check_patch_resize(dev, ds, scene):
    """Phase 3, K1's fused patch kernel (``patch_resize``) against its plain
    version, bit-exact: every slot of the slice's points in the slice's
    batches of 1024 and of the first walk scene's in the walk's batches of
    2048, a cap of 256, scenes of 1, 3, 4 and 5 bands, bf16 and float32
    patches. Then each slice slot's time at a batch of 1024 (median of 20
    launches) beside the plain version's and the unfused stage's
    (``unfused_slot``, as the extractor ran it: bounds check included), and
    its bound from the bytes the slot must move: each point's s x s x C
    window read once, its centre and side, and the patches written once."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.config import DataConfig
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.ops import patches
    from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
    from deepmerge_tpu_torch.train.sampler import stage_scene

    sizes = (32, 64, 128)
    t_phase = time.perf_counter()

    def slot_args(padded, caps, pts, inner, obj, batch, co, dtype):
        """patch_resize's arguments for every (slot, batch)."""
        scales = patches.adaptive_scales(inner, obj, sizes + (1,),
                                         device=dev)[0]
        centers = torch.as_tensor(pts, dtype=torch.int32, device=dev)
        pad = patches.scene_pad(caps, padded.shape[-1])
        return [(slot, (padded, centers[i : i + batch],
                        scales[i : i + batch, slot], cap, out, pad, co,
                        dtype))
                for slot, (cap, out) in enumerate(zip(caps, sizes))
                for i in range(0, len(pts), batch)]

    def staged(image, caps):
        c = image.shape[-1]
        return patches.pad_scene_device(
            torch.from_numpy(np.ascontiguousarray(image)).to(dev),
            patches.scene_pad(caps, c), patches.staged_channels(c))

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"slice": slot_args(ds.padded, ds.caps, ds.points_yx,
                                ds.point_inner, ds.point_object, 1024,
                                ds.channels, bf16)}
    walk = generate_scene(**SERVE_SCENE, seed=1, name="scene1")
    wds = stage_scene(walk, DataConfig(max_window=512), dev)
    cases["walk scene 1"] = slot_args(wds.padded, wds.caps, wds.points_yx,
                                      wds.point_inner, wds.point_object,
                                      SERVE_BATCH, wds.channels, bf16)
    caps256 = (256, 256, 256)
    cases["cap 256"] = slot_args(staged(scene.image, caps256), caps256,
                                 ds.points_yx, 2 * ds.point_inner,
                                 2 * ds.point_object, 1024, ds.channels, f32)
    rs = np.random.RandomState(7)
    for bands, dtype in ((1, f32), (3, bf16), (4, f32), (5, bf16)):
        n = 1024
        pts = np.stack([rs.randint(0, 512, n), rs.randint(0, 512, n)], 1)
        inner = rs.randint(2, 60, n)
        obj = inner + rs.randint(0, 40, n)
        image = rs.randint(0, 256, (512, 512, bands)).astype(np.uint8)
        cases[f"{bands} bands"] = slot_args(staged(image, (128,) * 3),
                                            (128,) * 3, pts, inner, obj, n,
                                            bands, dtype)
    worst, lines = 0.0, []
    for label, args in cases.items():
        errs = []
        for _, a in args:
            got = pr.patch_resize(*a, trusted_origins=True)
            errs.append(abs_err(got, pr.patch_resize_ref(*a)))
        worst = max(worst, *errs)
        padded, centers, _, _, _, _, co, dtype = args[0][1]
        caps = sorted({a[3] for _, a in args})
        lines.append(f"{label} ({padded.shape[-1]} staged channels, "
                     f"{co} kept, caps {caps}, {len(args)} launches, "
                     f"{dtype}): max |err| {max(errs)}")
    print(f"K1 patch_resize: bit-exact against its plain version (tol "
          f"{TOL_PATCHES}):")
    for line in lines:
        print(f"  {line}")
    require(worst <= TOL_PATCHES, f"patch_resize differs from its plain "
            f"version: {worst}")

    # timed at the slice's first batch of 1024 points, slot by slot
    stage = dict(ms=0.0, plain_ms=0.0, unfused_ms=0.0, bound_ms=0.0)
    out, first_batch = {}, {}
    for slot, a in cases["slice"]:
        first_batch.setdefault(slot, a)
    for slot, a in first_batch.items():
        padded, centers, scales, cap, size, pad, co, dtype = a
        ms = cuda_median_ms(lambda: pr.patch_resize(*a, trusted_origins=True))
        plain_ms = cuda_median_ms(lambda: pr.patch_resize_ref(*a), reps=5)
        unfused_ms = cuda_median_ms(lambda: unfused_slot(*a), reps=5)
        s = scales.clamp(1, cap).to(torch.float64)
        nbytes = (float((s * s).sum()) * padded.shape[-1]
                  + centers.shape[0] * 12
                  + centers.shape[0] * size * size * co * 2)
        b = bound(nbytes)
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("unfused_ms", unfused_ms), ("bound_ms", b["bound_ms"])):
            stage[k] += v
        print(f"  slot {slot} (out {size}, cap {cap}, {centers.shape[0]} "
              f"points): {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
              f"(K1 + products) {unfused_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {nbytes / 1e6:.1f} "
              f"MB); bound / time {b['bound_ms'] / ms:.1%}")
        out = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                   library_ms=None, **b)
    print(f"  the stage (3 launches, 1024 points): {stage['ms']:.4f} ms, "
          f"plain {stage['plain_ms']:.4f} ms, unfused "
          f"{stage['unfused_ms']:.4f} ms, bound {stage['bound_ms']:.4f} ms; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    # the row of the kernels line: the largest slot (out 128)
    return {"patch_resize": out}


def target(ok):
    return "met" if ok else "NOT met"


def check_gemms(dev):
    """Phase 3: K2's GEMM alone on the four shapes of a stage-0 block at
    B 1024, N 192 (M 196,608: qkv 2304x768, proj 768x768 with the
    residual, up 3072x768 with the GELU, down 768x3072 with the residual),
    each against its plain version on the first 4096 rows, its time and
    TFLOP/s beside one ``torch.matmul`` of the same shape (the yardstick;
    the port never calls it for these)."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    m, c, hidden = 1024 * 192, 768, 3072
    rs = np.random.default_rng(3)
    r = lambda *shape, s=1.0: torch.from_numpy(
        (rs.standard_normal(shape) * s).astype(np.float32)).to(
            dev, torch.bfloat16)
    total_ms = 0.0
    for what, n, k, epi in (("qkv", 3 * c, c, "bias_cast"),
                            ("proj", c, c, "bias_residual"),
                            ("up", hidden, c, "bias_gelu"),
                            ("down", c, hidden, "bias_residual")):
        a, w, bias = r(m, k), r(n, k, s=k ** -0.5), r(n, s=0.1)
        resid = r(m, n) if epi == "bias_residual" else None
        got = fb.gemm(a, w, bias, epi, resid)[0][:4096]
        want = fb.gemm_ref(a[:4096], w, bias, epi,
                           None if resid is None else resid[:4096])[0]
        err = rel_err(got, want)
        require(err <= TOL_BLOCK, f"GEMM {what} differs from plain: {err}")
        ms = cuda_ms(lambda: fb.gemm(a, w, bias, epi, resid))
        mm_ms = cuda_ms(lambda: torch.matmul(a, w.t()))
        tf = 2 * m * n * k / ms / 1e9
        total_ms += ms
        print(f"GEMM {what} ({epi}) {m}x{n}x{k}: rel err {err:.3e} (tol "
              f"{TOL_BLOCK}); {ms:.3f} ms, {tf:.0f} TFLOP/s (target >= "
              f"{TARGET_GEMM_TFLOPS:.0f}: {target(tf >= TARGET_GEMM_TFLOPS)}"
              f"); torch.matmul {mm_ms:.3f} ms, "
              f"{2 * m * n * k / mm_ms / 1e9:.0f} TFLOP/s")
        del a, w, bias, resid, got, want
        torch.cuda.empty_cache()
    print(f"GEMMs of one stage-0 block at B 1024: {total_ms:.3f} ms")
    return total_ms


def check_gemms_q8(dev):
    """Phase 3: K4's s8 GEMM alone on the four shapes of a stage-0 block at
    B 1024, N 192 (M 196,608: qkv 2304x768 cast, proj 768x768 residual, up
    3072x768 GELU, down 768x3072 residual), with dynamic row scales and
    with a static scale, on random codes: the cast and residual outputs
    bit-identical to ``gemm_q8_ref`` on the same codes and scales (first
    4096 rows); the GELU output within ``TOL_BLOCK``, its int8 codes and
    row scales bit-identical to ``quantize_rows`` of its own float32 h1,
    and the static codes epilogue bit-identical to ``quantize_rows`` of
    that h1 at the static scale; one call's s32 sums equal to
    ``torch._int_mm``'s; the same on the last 4096 rows of a ragged M
    (B 1021, N 193: M 197,053, 61 rows in the last 128-row tile). Prints
    each shape's ms and TOP/s beside ``torch._int_mm`` (the yardstick; the
    port never calls it) and K2's bf16 GEMM on the same shape. Returns the
    time of the four GEMMs."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    c, hidden, rows = 768, 3072, 4096
    # inputs drawn on the card from a seeded generator (a 600 MB operand
    # takes seconds through numpy)
    g = torch.Generator(device=dev).manual_seed(4)
    codes = lambda *shape: torch.randint(-127, 128, shape, generator=g,
                                         device=dev, dtype=torch.int8)
    uni = lambda n, lo, hi: torch.empty(n, device=dev).uniform_(
        lo, hi, generator=g)
    normal = lambda *shape, s=1.0: (torch.randn(
        shape, generator=g, device=dev) * s).to(torch.bfloat16)
    static = torch.tensor([0.03], dtype=torch.float32, device=dev)
    shapes = (("qkv", 3 * c, c, "bias_cast"), ("proj", c, c, "bias_residual"),
              ("up", hidden, c, "bias_gelu"), ("down", c, hidden,
                                               "bias_residual"))
    total_ms = 0.0
    for m in (1024 * 192, 1021 * 193):
        ragged = m % 128 != 0
        sl = slice(m - rows, m) if ragged else slice(0, rows)
        for what, n, k, epi in shapes:
            a, w = codes(m, k), codes(n, k)
            ws, sr = uni(n, 3e-4, 9e-4), uni(m, 0.01, 0.05)
            bias = normal(n, s=0.1)
            resid = normal(m, n) if epi == "bias_residual" else None
            args = lambda t, rsl=slice(None): dict(
                resid=None if resid is None else resid[rsl], **t)
            for mode, scale in (("dynamic", dict(row_scale=sr)),
                                ("static", dict(static_scale=static))):
                part = dict(row_scale=sr[sl]) if mode == "dynamic" else scale
                got, aux = fb.gemm_q8(a, w, ws, bias, epi, **args(scale))
                want, _ = fb.gemm_q8_ref(a[sl], w, ws, bias, epi,
                                         **args(part, sl))
                if epi == "bias_gelu":
                    err = rel_err(got[sl], want)
                    require(err <= TOL_BLOCK, f"s8 GEMM {what} GELU ({mode}, "
                            f"M {m}) differs from plain: {err}")
                    qc, qs = fb.quantize_rows(got[sl])
                    require(torch.equal(aux[0][sl], qc)
                            and torch.equal(aux[1][sl], qs),
                            f"s8 GEMM {what} ({mode}, M {m}): h1's codes or "
                            "row scales differ from quantize_rows of its h1")
                    out_scale = (got.abs().max() * 0.8 / 127).reshape(1)
                    hq, _ = fb.gemm_q8(a, w, ws, bias, "bias_gelu_codes",
                                       out_scale=out_scale, **scale)
                    require(torch.equal(
                        hq[sl], fb.quantize_rows(got[sl], out_scale)[0]),
                        f"s8 GEMM {what} ({mode}, M {m}): static h1 codes "
                        "differ from quantize_rows of its h1")
                    check = (f"rel err {err:.3e} (tol {TOL_BLOCK}), codes "
                             "and scales bit-identical")
                else:
                    require(torch.equal(got[sl], want), f"s8 GEMM {what} "
                            f"{epi} ({mode}, M {m}) is not bit-identical to "
                            f"plain: max |err| {abs_err(got[sl], want)}")
                    check = "bit-identical"
                print(f"GEMM q8 {what} ({epi}, {mode}) {m}x{n}x{k}: {check}")
                del got, aux, want
            acc, _ = fb.gemm_q8(a, w, ws, bias, "acc", row_scale=sr)
            if ragged:
                require(torch.equal(acc[sl], fb.gemm_q8_ref(
                    a[sl], w, ws, bias, "acc", row_scale=sr[sl])[0]),
                    f"s8 GEMM {what} (M {m}): s32 sums differ from plain")
            else:
                require(torch.equal(acc, torch._int_mm(a, w.t())),
                        f"s8 GEMM {what} (M {m}): s32 sums differ from "
                        "torch._int_mm's")
            del acc
            if not ragged:
                ops = 2 * m * n * k
                ms = cuda_ms(lambda: fb.gemm_q8(a, w, ws, bias, epi,
                                                row_scale=sr, resid=resid))
                int_ms = cuda_ms(lambda: torch._int_mm(a, w.t()))
                ab, wb = normal(m, k), normal(n, k, s=k ** -0.5)
                bf_ms = cuda_ms(lambda: fb.gemm(ab, wb, bias, epi, resid))
                del ab, wb
                tops = lambda t: ops / t / 1e9
                total_ms += ms
                print(f"GEMM q8 {what} ({epi}) {m}x{n}x{k}: {ms:.3f} ms "
                      f"({tops(ms):.0f} TOP/s); torch._int_mm {int_ms:.3f} "
                      f"ms ({tops(int_ms):.0f} TOP/s, s32 out); K2's bf16 "
                      f"GEMM {bf_ms:.3f} ms ({tops(bf_ms):.0f} TFLOP/s); "
                      f"target >= 1.5x bf16: {target(ms <= bf_ms / 1.5)}")
            del a, w, ws, sr, bias, resid
            torch.cuda.empty_cache()
    print(f"s8 GEMMs of one stage-0 block at B 1024: {total_ms:.3f} ms")
    return total_ms


def check_k4a_core(dev):
    """Phase 3: K4a's int8 core alone (``attention_q8``) at B 1024 and
    N = 192, 193, 48, 12 and 256, dynamic and static scales (the abs-max of
    each third of qkv, shrunk so that some codes saturate), against its
    plain version within ``TOL_K7``, its time beside the bf16 core's (K7's
    ``attention_qkv``, the same shape): how K4a's block time splits
    between its core and the rest."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    c, heads = 768, 12
    results = {}
    for b, n in ((1024, 192), (1024, 193), (1024, 48), (1024, 12),
                 (1024, 256)):
        g = torch.Generator(device=dev).manual_seed(n + 13)
        qkv = torch.randn((b, n, 3 * c), generator=g, device=dev).to(
            torch.bfloat16)
        bias = torch.randn((heads, n, n), generator=g, device=dev) * 0.5
        static = torch.stack([qkv[..., i * c:(i + 1) * c].float().abs().max()
                              * 0.8 / 127 for i in range(3)]).contiguous()
        bf_ms = cuda_ms(lambda: fa.attention_qkv(qkv, bias, heads))
        line = []
        for mode, st in (("dynamic", None), ("static", static)):
            got = fb.attention_q8(qkv, bias, heads, static=st)
            want = fb.attention_q8_ref(qkv, bias, heads, st)
            err = rel_err(got, want)
            require(err <= TOL_K7, f"K4a core (B={b}, N={n}, {mode}) differs "
                    f"from plain: {err} > {TOL_K7}")
            ms = cuda_ms(lambda: fb.attention_q8(qkv, bias, heads, static=st))
            results[(n, mode)] = ms
            line.append(f"{mode} rel err {err:.3e} (tol {TOL_K7}), "
                        f"{ms:.4f} ms")
            del got, want
        print(f"K4a core attention_q8 B={b} N={n}: {'; '.join(line)}; bf16 "
              f"core (K7) {bf_ms:.4f} ms")
        del qkv, bias
        torch.cuda.empty_cache()
    return results


def check_label_lookup(dev, scene):
    """Phase 3: K9, the label-map relabel lookup, bit-exact against its
    plain version on the slice's own 1024² map (R 2048, the slices' region
    bucket) and on a random 2048² map into R 8192 (the walk's scenes; the
    TPU probe's input), with ids out of range on a copy of the first;
    timed beside its plain version, the PyTorch call the port ran before
    it (``dense[region_map.long()]``, the cast included) and its bound (8
    bytes a pixel and the table, over the memory rate), each by the device
    time of its kernels (``kernel_ms``). Returns the 1024² numbers (the
    slices' shape)."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import label_lookup as ll

    g = torch.Generator(device=dev).manual_seed(9)
    cases = (("slice map 1024², R 2048", 2048,
              torch.from_numpy(scene.labels.astype("int32")).to(dev)),
             ("random 2048², R 8192", 8192,
              torch.randint(0, 8192, (2048, 2048), generator=g, device=dev,
                            dtype=torch.int32)))
    results = {}
    for label, r, ids in cases:
        table = torch.randint(0, r, (r,), generator=g, device=dev,
                              dtype=torch.int32)
        for what, m in (("", ids), (", ids out of range", torch.where(
                torch.rand(ids.shape, generator=g, device=dev) < 0.01,
                ids + (2 * r + 1) * (ids % 2 * 2 - 1), ids))):
            got = ll.label_lookup(table, m)
            require(torch.equal(got, ll.label_lookup_ref(table, m)),
                    f"K9 label_lookup ({label}{what}) differs from plain")
        call_ms = cuda_median_ms(lambda: ll.label_lookup(table, ids))
        ms = kernel_ms(lambda: ll.label_lookup(table, ids))
        plain_ms = kernel_ms(lambda: ll.label_lookup_ref(table, ids))
        library_ms = kernel_ms(lambda: table[ids.long()])
        b = bound(8 * ids.numel() + 4 * r)
        print(f"K9 label_lookup {label}: bit-exact (also with ids out of "
              f"range); device time of 20 launches (profiler): {ms:.4f} ms "
              f"a launch (a call with the host's launch path, median of "
              f"20: {call_ms:.4f} ms), plain {plain_ms:.4f} "
              f"ms, dense[map.long()] {library_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{b['bound_ms'] / ms:.2f} of it; target >= 0.5 and no slower "
              f"than the library call: "
              f"{target(b['bound_ms'] / ms >= 0.5 and ms <= library_ms)})")
        results[label] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, **b)
        del table, got
    return {"label_lookup": results[cases[0][0]]}


def check_int4_dot(dev):
    """Phase 3: K10, the int4 dot probe, at the TPU probe's shape (M 4096,
    K 768, N 3072; operands in its ranges, int8 in [-100, 100), int4 in
    [-7, 7]): each variant that assembles bit-exact against its plain
    version and timed (mean of 20) in TOP/s, beside ``torch._int_mm`` and
    K4's s8 ``wgmma`` GEMM (its s32 ``acc`` epilogue) on the same int8
    operands and its bound (the int32 output outweighs the operations).
    The s4 x s4 variant is built alone: a refusal of its ``mma`` by ptxas
    is printed as the probe's answer. Returns the w4a8 variant's numbers
    and the probe's launches."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import build
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import int4_dot as i4

    m, k, n = 4096, 768, 3072
    g = torch.Generator(device=dev).manual_seed(41)
    a8 = torch.randint(-100, 100, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    b8t = torch.randint(-100, 100, (n, k), generator=g, device=dev,
                        dtype=torch.int8)
    a4 = torch.randint(-7, 8, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    b4t = torch.randint(-7, 8, (n, k), generator=g, device=dev,
                        dtype=torch.int8)
    ops = 2 * m * k * n
    tops = lambda ms: ops / ms / 1e9
    operands = {"s8s8": (a8, b8t), "s4s4": (i4.pack_int4(a4),
                                            i4.pack_int4(b4t)),
                "s8s4": (a8, i4.pack_int4(b4t))}
    try:
        build.build_all(["int4_dot_s4"])
        s4_built = True
    except RuntimeError as e:
        s4_built = False
        print(f"K10 s4 x s4 (mma.sync m16n8k64 s4) does not assemble for "
              f"sm_90a; nvcc/ptxas said:\n{e}")
    results, launches = {}, 0
    for variant, (a, bt) in operands.items():
        if variant == "s4s4" and not s4_built:
            continue
        got = i4.int4_dot(a, bt, variant)
        require(torch.equal(got, i4.int4_dot_ref(a, bt, variant)),
                f"K10 int4_dot {variant} differs from plain")
        del got
        i4.int4_dot.launches = 0
        ms = cuda_ms(lambda: i4.int4_dot(a, bt, variant), reps=20)
        launches += i4.int4_dot.launches
        plain_ms = cuda_ms(lambda: i4.int4_dot_ref(a, bt, variant), reps=2)
        nbytes = a.numel() + bt.numel() + 4 * m * n
        b = bound(nbytes, int8_ops=ops)
        results[variant] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                **b)
        print(f"K10 int4_dot {variant} {m}x{n}x{k}: bit-exact; {ms:.4f} ms "
              f"({tops(ms):.0f} TOP/s), plain {plain_ms:.3f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    print("K10 s8 x s4 without widening: PTX has no mixed-operand mma "
          "(s8 x s4), the TPU probe's third variant; s8s4 above is the "
          "widened w4a8 form")
    int_ms = cuda_ms(lambda: torch._int_mm(a8, b8t.t()), reps=20)
    ws = torch.full((n,), 1e-3, device=dev)
    sr = torch.full((m,), 1e-2, device=dev)
    bias = torch.zeros((n,), dtype=torch.bfloat16, device=dev)
    acc, _ = fb.gemm_q8(a8, b8t, ws, bias, "acc", row_scale=sr)
    require(torch.equal(acc, i4.int4_dot_ref(a8, b8t, "s8s8")),
            "K4's s8 GEMM (acc) differs from the probe's plain version")
    k4_ms = cuda_ms(lambda: fb.gemm_q8(a8, b8t, ws, bias, "acc",
                                       row_scale=sr), reps=20)
    print(f"K10 beside: torch._int_mm {int_ms:.4f} ms ({tops(int_ms):.0f} "
          f"TOP/s); K4's s8 wgmma GEMM (acc epilogue) {k4_ms:.4f} ms "
          f"({tops(k4_ms):.0f} TOP/s); "
          + "; ".join(f"{v} {tops(r['ms']):.0f} TOP/s, "
                      f"{results['s8s8']['ms'] / r['ms']:.2f}x s8s8's rate"
                      for v, r in results.items()))
    out = dict(results["s8s4"], library_ms=int_ms)
    return {"int4_dot": out}, launches


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


def check_k4a(dev):
    """Phase 3, ``w8a8+attn``: the w8a8 block (N = 192, 193) and chains
    (N = 48/49 x 4, N = 12/13 x 2) with the int8 attention core (K4a),
    dynamic and static scales (from ``block_act_amax`` along the plain
    chain, as ``check_k4``), at the slice's chunk of 1024, against their
    plain versions, each timed beside K4 (the bf16 attention core) on the
    same input. Returns the JSON entries of the block (N 192) and the chain
    (both stages summed), dynamic scales."""
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    b, results = 1024, {}
    for n, depth in ((192, 1), (48, 4), (12, 2), (193, 1), (49, 4), (13, 2)):
        x, plist, heads = block_inputs(b, n, depth, dev, seed=n + 11)
        for static in (False, True):
            qps, h = [], x
            for p in plist:
                amax = fb.block_act_amax(h, p, heads)[1] if static else None
                qp = fb.quantize_block_params(p, amax)
                h = fb.block_ref_q8(h, qp, heads, quant_attn=True).to(x.dtype)
                qps.append(qp)
            if depth == 1:
                name, tol, tol_rms = ("fused_block_q8_attn", TOL_BLOCK,
                                      TOL_BLOCK_RMS)
                run = lambda: fb.fused_block_q8_attn(x, qps[0], heads)
                k4 = lambda: fb.fused_block_q8(x, qps[0], heads)
                plain = lambda: fb.block_ref_q8(x, qps[0], heads,
                                                quant_attn=True)
            else:
                name, tol, tol_rms = ("fused_block_chain_q8_attn", TOL_CHAIN,
                                      TOL_CHAIN_RMS)
                run = lambda: fb.fused_block_chain_q8_attn(x, qps, heads)
                k4 = lambda: fb.fused_block_chain_q8(x, qps, heads)
                plain = lambda: fb.chain_ref_q8(x, qps, heads,
                                                quant_attn=True)
            mode = "static" if static else "dynamic"
            aerr, errs = check_block(
                f"{name} (B={b}, N={n}, depth {depth}, {mode})", run(),
                plain(), x, tol, tol_rms)
            ms, k4_ms = cuda_ms(run), cuda_ms(k4)
            plain_ms = cuda_ms(plain, reps=2)
            print(f"K4a {name} B={b} N={n} depth {depth} {mode}: {errs}; "
                  f"{ms:.3f} ms (K4, bf16 attention: {k4_ms:.3f} ms; target "
                  f"<= 1.2x K4: {target(ms <= 1.2 * k4_ms)}), plain "
                  f"{plain_ms:.3f} ms")
            results[(n, mode)] = dict(max_abs_err=aerr, ms=ms,
                                      plain_ms=plain_ms)
            del qps, h
        del x, plist
        torch.cuda.empty_cache()
    s1, s2 = results[(48, "dynamic")], results[(12, "dynamic")]
    ba = bound(*block_work(b, 192, 1, q8=True, q8_attn=True))
    bc = bound(*add_work(block_work(b, 48, 4, q8=True, q8_attn=True),
                         block_work(b, 12, 2, q8=True, q8_attn=True)))
    print(f"K4a at B={b}: block bound {ba['bound_ms']:.3f} ms "
          f"({ba['bound_by']}), chain (both stages) bound "
          f"{bc['bound_ms']:.3f} ms ({bc['bound_by']})")
    return {
        "fused_block_q8_attn": dict(results[(192, "dynamic")],
                                    library_ms=None, **ba),
        "fused_block_chain_q8_attn": dict(
            max_abs_err=max(s1["max_abs_err"], s2["max_abs_err"]),
            ms=s1["ms"] + s2["ms"], plain_ms=s1["plain_ms"] + s2["plain_ms"],
            library_ms=None, **bc),
    }


def check_k5(dev):
    """Phase 3, the training block (K5) at the training batch and the
    lengths of v3 (192/48/12) and v5 (193/49/13): its output and its four
    saved residuals against ``block_train_ref``, the gradients of x and of
    every parameter through the autograd function on the kernel's forward
    against the plain forward, its time beside the plain version's, and
    the backward's (plain torch) time at N 192. Returns the JSON entry at
    N 192."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.ops.kernels import fused_block as fb

    b, results = 2 * TRAIN_PAIRS, {}
    for n in (192, 48, 12, 193, 49, 13):
        x, plist, heads = block_inputs(b, n, 1, dev, seed=n + 21)
        p = plist[0]
        out, saved = fb.fused_block_train(x, p, heads)
        want_out, want = fb.block_train_ref(x, p, heads)
        aerr, errs = check_block(f"K5 out (N={n})", out, want_out, x,
                                 TOL_BLOCK, TOL_BLOCK_RMS)
        _, r_errs = check_block(f"K5 r (N={n})", saved[3], want[3], x,
                                TOL_BLOCK, TOL_BLOCK_RMS)
        probs_err = abs_err(saved[1], want[1])
        qkv_err, gin_err = (rel_err(saved[i], want[i]) for i in (0, 2))
        require(probs_err <= TOL_K6_PROBS, f"K5 probs (N={n}): {probs_err}")
        require(max(qkv_err, gin_err) <= TOL_K5_SAVED,
                f"K5 qkv {qkv_err}, gin {gin_err} (N={n}) > {TOL_K5_SAVED}")
        rs = np.random.default_rng(n)
        g = torch.from_numpy(rs.standard_normal(x.shape).astype(
            np.float32)).to(dev, x.dtype)

        def grads():
            xs = x.clone().requires_grad_(True)
            ps = [t.clone().requires_grad_(True) for t in p]
            fb.fused_block(xs, ps, heads).backward(g)
            return [xs.grad] + [t.grad for t in ps]

        got_g = grads()
        with mock.patch.object(fb, "fused_block_train", fb.block_train_ref):
            want_g = grads()
        g_err = max(rel_err(a, w) for a, w in zip(got_g, want_g))
        require(g_err <= TOL_K5_GRAD, f"K5 gradients (N={n}): {g_err} > "
                f"{TOL_K5_GRAD}")
        ms = cuda_ms(lambda: fb.fused_block_train(x, p, heads))
        plain_ms = cuda_ms(lambda: fb.block_train_ref(x, p, heads), reps=2)
        bk = bound(*train_block_work(b, n))
        line = (f"K5 fused_block_train B={b} N={n}: out {errs}; r {r_errs}; "
                f"probs max |err| {probs_err:.3e} (tol {TOL_K6_PROBS}), qkv "
                f"{qkv_err:.3e}, gin {gin_err:.3e} (tol {TOL_K5_SAVED}); "
                f"gradients of x and the 13 parameters max rel err "
                f"{g_err:.3e} (tol {TOL_K5_GRAD}); {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bk['bound_ms']:.3f} ms "
                f"({bk['bound_by']})")
        if n == 192:
            bwd_ms = cuda_ms(lambda: fb.block_train_bwd(x, p, saved, g,
                                                        heads), reps=2)
            line += f"; backward (plain torch) {bwd_ms:.3f} ms"
        print(line)
        results[n] = dict(max_abs_err=aerr, ms=ms, plain_ms=plain_ms,
                          library_ms=None, **bk)
        del x, plist, p, out, saved, want_out, want, g, got_g, want_g
        torch.cuda.empty_cache()
    return {"fused_block_train": results[192]}


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
        goals = []
        if n >= 192:
            goals.append(f"target <= SDPA: {target(ms <= lib_ms)}")
        if (b, n) == (1024, 193):
            goals.append(f"target <= {TARGET_K7_BOUND_FACTOR:.0f}x bound: "
                         f"{target(ms <= TARGET_K7_BOUND_FACTOR * bk['bound_ms'])}")
        print(f"K7 attention_qkv B={b} N={n} C={c} H={heads}: rel err "
              f"{err:.3e} (tol {TOL_K7}); {ms:.4f} ms, plain {plain_ms:.3f} "
              f"ms, SDPA {lib_ms:.4f} ms, bound {bk['bound_ms']:.4f} ms "
              f"({bk['bound_by']}){'; ' if goals else ''}{', '.join(goals)}")
        if n in (192, 193):
            # other launch plans of the same core: warps a CTA (4 warps x 3
            # query tiles or 12 x 1) and samples a CTA
            sweep = []
            for warps, samples in ((4, 1), (4, 4), (12, 1), (12, 4)):
                plan = fb.attention_plan(b, n, heads, warps, samples)
                got_p = fa.attention_qkv(qkv, bias, heads, plan=plan)
                require(torch.equal(got_p, got), f"K7 plan {plan['ints']} "
                        "computes other bits than the default plan")
                sweep.append(f"{warps} warps x {samples} samples "
                             f"{cuda_ms(lambda: fa.attention_qkv(qkv, bias, heads, plan=plan)):.4f} ms")
            default = fb.attention_plan(b, n, heads)
            print(f"  K7 plans at N={n} (default {default['warps']} warps x "
                  f"{default['samples']} samples, {default['ctas_per_sm']} "
                  f"CTAs an SM): {'; '.join(sweep)}")
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


def profile_slice(run_slice, top=8, label="slice", ops=0, ranges=()):
    """One profiled run of the slice (or of ``label``): the device's busy
    share (kernel time over wall time) and the kernels that take the most
    device time; with ``ops``, also the PyTorch operators whose own kernels
    take the most device time, and the matrix products' share; for each of
    ``ranges`` (``record_function`` names), the device time of the kernels
    launched inside it and its share of busy. Returns the run's result."""
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
    for name in ranges:
        ms = sum(e.device_time_total for e in prof.key_averages()
                 if e.key == name and e.device_type == DeviceType.CPU) / 1e3
        print(f"  range {name}: {ms:.2f} ms of device time ({ms / busy_ms:.1%} "
              f"of busy)")
    return out


def counters():
    """Every kernel wrapper, by the name its launch count goes under."""
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import int4_dot as i4
    from deepmerge_tpu_torch.ops.kernels import label_lookup as ll
    from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    return {"patch_resize": pr.patch_resize,
            "window_gather": wg.gather_windows,
            "fused_block": fb.fused_block,
            "fused_block_chain": fb.fused_block_chain,
            "fused_block_q8": fb.fused_block_q8,
            "fused_block_chain_q8": fb.fused_block_chain_q8,
            "fused_block_q8_attn": fb.fused_block_q8_attn,
            "fused_block_chain_q8_attn": fb.fused_block_chain_q8_attn,
            "fused_block_train": fb.fused_block_train,
            "fused_attention_train": fa.attention_probs,
            "attention_qkv": fa.attention_qkv,
            "attention_bnhd": fa.attention_bnhd,
            "label_lookup": ll.label_lookup,
            "int4_dot": i4.int4_dot}


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
    from deepmerge_tpu_torch.ops import labelprop, patches
    from deepmerge_tpu_torch.ops.kernels import fused_attention as fa
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.ops.kernels import label_lookup as ll
    from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    def gather_ref(*args, trusted_origins=False):
        return wg.gather_windows_ref(*args)

    def resize_ref(*args, trusted_origins=False, **kwargs):
        return pr.patch_resize_ref(*args, **kwargs)

    def block_plain(x, params, heads, exact_gelu=False):
        # under autograd the block's training path, whose forward
        # (fused_block_train) is patched below; else the inference block
        if fb._needs_grad(x, [params]):
            return fb.fused_block(x, params, heads, exact_gelu)
        return fb.block_ref(x, params, heads, exact_gelu)

    stack = contextlib.ExitStack()
    for module, attr, ref in (
            (patches, "patch_resize", resize_ref),
            (patches, "gather_windows", gather_ref),
            (fa, "attention_probs", fa.attention_probs_ref),
            (fa, "attention_qkv", fa.attention_qkv_ref),
            (fa, "attention_bnhd", fa.attention_bnhd_ref),
            (fb, "fused_block_train", fb.block_train_ref),
            (s2former, "fused_block", block_plain),
            (s2former, "fused_block_chain", fb.chain_ref),
            (s2former, "fused_block_q8", fb.block_ref_q8),
            (s2former, "fused_block_chain_q8", fb.chain_ref_q8),
            (labelprop, "label_lookup", ll.label_lookup_ref)):
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


def feature_stores(stores):
    """A context in which the walk keeps each scene's embeddings in an
    in-memory ``FeatureStore`` (``stores[scene name]``) where h5py is
    missing; each scene writes its .h5 where it is there."""
    from deepmerge_tpu_torch.infer import driver, extract

    if extract.HAS_H5PY:
        return contextlib.nullcontext()

    def in_memory_store(path):
        store = extract.FeatureStore(None)
        stores[os.path.basename(os.path.dirname(path))] = store
        return store

    return mock.patch.object(driver, "FeatureStore", in_memory_store)


def serving_walk(model, dev, card, walk):
    """Phase 6: ``process_folder`` over the serving scenes ``walk`` (the
    image and shapefile folders and each scene's point and edge counts, from
    ``export_folder``); returns the launch counts of the walk."""
    import numpy as np

    from deepmerge_tpu_torch.config import Config, DataConfig, MergeConfig
    from deepmerge_tpu_torch.geodata.shapefile import ShapefileTable
    from deepmerge_tpu_torch.infer import driver, extract

    cfg = Config(model=model.cfg,
                 data=DataConfig(max_window=512, eval_batch_size=SERVE_BATCH),
                 merge=MergeConfig(engine="device"))
    stores = {}  # scene name -> in-memory store, where h5py is missing
    print("h5py: available; each scene writes its .h5" if extract.HAS_H5PY
          else "h5py: missing on this machine; the walk keeps each scene's "
          "embeddings in an in-memory FeatureStore")
    ex = extract.FeatureExtractor(model, batch_size=SERVE_BATCH, device=dev)
    images, shps, counts = walk
    stats, log = {}, []
    t0 = time.perf_counter()
    with feature_stores(stores):
        done, launches = counted(lambda: driver.process_folder(
            cfg, images, shps, log_fn=log.append, write_labelmaps=True,
            extractor=ex, stats=stats, device=dev))
    wall = time.perf_counter() - t0
    for line in log:
        if line.startswith(("  walk[", "  prefetch[", "FAILED")):
            print(line)
    print(f"walk launches: {launches}")
    want = len(cfg.model.input_image_scales) * sum(
        -(-n // SERVE_BATCH) for n, _ in counts.values())
    require(launches["patch_resize"] == want, f"patch_resize launched "
            f"{launches['patch_resize']} times on the walk, want {want}")
    require(done == sorted(counts), f"scenes done: {done} of "
            f"{sorted(counts)}")
    tag = cfg.model.name
    maps = walk_maps(shps, done, tag)
    for name, (n_points, n_edges) in counts.items():
        simi = ShapefileTable.read(
            os.path.join(shps, name, "lines.shp")).get_field("simi")
        simi = np.asarray(simi, np.float64)
        require(simi.shape == (n_edges,) and np.isfinite(simi).all(),
                f"{name}: simi {simi.shape} finite "
                f"{np.isfinite(simi).mean()}")
        require(maps[name].shape == (SERVE_SCENE["h"], SERVE_SCENE["w"]),
                f"{name}: merged map {maps[name].shape}")
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


def walk_maps(shps, names, tag):
    """Each walk scene's merged label map, decoded from the three uint8
    planes of its ``<model>_merged.tif``."""
    import numpy as np

    from deepmerge_tpu_torch.geodata.geotiff import read_geotiff

    out = {}
    for name in names:
        a = read_geotiff(os.path.join(shps, name, f"{tag}_merged.tif"))
        a = a.array.astype(np.int64)
        out[name] = a[..., 0] | a[..., 1] << 8 | a[..., 2] << 16
    return out


def training_phase(dev, card, mcfg, label, aux_weights=(0.0, 0.0),
                   fused_block=False):
    """Phase 7 for ``mcfg``: ``train.driver.train`` (see the module
    docstring), the aux heads' BatchNorm statistics checked to move for v4
    and v5; with ``fused_block``, ``train.fused_block=True`` (every block
    through K5, none through K6). Returns the launch counts of the training
    run and ``(median ms a step, the kernels' four losses)``."""
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

    import warnings

    scene = generate_scene(**SCENE)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # train.fused_block's experiment note
        cfg = Config(
            model=mcfg,  # bf16 compute, f32 parameters
            data=DataConfig(batch_size=TRAIN_PAIRS, max_window=512),
            train=TrainConfig(num_epochs=TRAIN_EPOCHS, checkpoint_every=1,
                              checkpoint_dir=os.path.join(root, "ck"),
                              log_dir=os.path.join(root, "logs"),
                              aux_weights=aux_weights,
                              fused_block=fused_block))
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
        per_step = "fused_block_train" if fused_block else \
            "fused_attention_train"
        require(launches[per_step] == blocks * steps,
                f"{per_step} launched {launches[per_step]} times, want "
                f"{blocks} a step")
        slots = len(cfg.data.patch_sizes)
        require(launches["patch_resize"] == slots * steps,
                f"patch_resize launched {launches['patch_resize']} times, "
                f"want {slots} a step")
        require_launches(launches, ("patch_resize", per_step),
                         [k for k in launches
                          if k not in ("patch_resize", per_step)],
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
    return launches, (med * 1e3, got)


def train_trusted(dev, scene, mcfg):
    """``mcfg`` trained by ``train.driver.train`` on the slice's scene
    (unfused blocks, bf16 compute, ``TRAIN_PAIRS`` pairs a step) for
    ``TRUSTED_EPOCHS`` epochs; returns its state dict."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deepmerge_tpu_torch.config import Config, DataConfig, TrainConfig
    from deepmerge_tpu_torch.train.driver import train

    root = tempfile.mkdtemp(prefix="chip_smoke_trusted_")
    never = 10 ** 6
    cfg = Config(model=mcfg,
                 data=DataConfig(batch_size=TRAIN_PAIRS, max_window=512),
                 train=TrainConfig(num_epochs=TRUSTED_EPOCHS,
                                   checkpoint_every=never,
                                   checkpoint_tail_from=never,
                                   checkpoint_dir=os.path.join(root, "ck"),
                                   log_dir=os.path.join(root, "logs")))
    try:
        log = []
        t = time.perf_counter()
        state, history = train(cfg, scene=scene, log_fn=log.append,
                               device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = np.asarray(history.train_losses)
    require(np.isfinite(losses).all(), f"trained losses {losses}")
    steps = int(state.step)
    print(f"trained weights ({mcfg.variant}): {steps} steps "
          f"({TRUSTED_EPOCHS} epochs) of {TRAIN_PAIRS} pairs in "
          f"{train_s:.1f} s ({train_s / steps * 1e3:.1f} ms/step); "
          f"epoch-mean loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    trained = {k: v.detach().clone() for k, v in
               state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    return trained


def trained_extractor(dev, trained, batch, quantize="", **model_kw):
    """A ``FeatureExtractor`` of the model ``ModelConfig(quantize=...,
    **model_kw)`` with the ``trained`` weights."""
    import warnings

    from deepmerge_tpu_torch.config import ModelConfig
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.models import s2former

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mcfg = ModelConfig(quantize=quantize, **model_kw)
    model = s2former.S2Former(mcfg)
    model.load_state_dict(trained, strict=True)
    return FeatureExtractor(model, batch_size=batch, device=dev)


def calibrated_threshold(dev, trained, dcfg, **model_kw):
    """An absolute threshold for the trained bf16 model, calibrated on a
    second scene (``calibrate_threshold``, the root eval.py's
    procedure)."""
    import torch

    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.infer.calibrate import calibrate_threshold

    val = generate_scene(**dict(SCENE, seed=SCENE["seed"] + 500))
    ex = trained_extractor(dev, trained, dcfg.eval_batch_size, **model_kw)
    val_emb = torch.from_numpy(ex.extract_scene(val, dcfg)).to(dev)
    cal = calibrate_threshold(val, val_emb, max_rounds=8)
    print(f"calibrated on the scene of seed {SCENE['seed'] + 500} "
          f"({model_kw or 'v3'}): threshold {cal.threshold:.6f} "
          f"({cal.disagreement:.5f} pair disagreement with its objects, "
          f"{cal.clusters} clusters)")
    del ex, val_emb
    torch.cuda.empty_cache()
    return cal.threshold


def parity_gate(label, thr, emb, d, maps, gt=None):
    """Phase 8's bar, the kernels' run against the plain versions' on
    trained weights: ``emb``, ``d`` (the valid edges' distances) and
    ``maps`` (the merged label maps) as (kernels, plain) pairs. Gates the
    label disagreement at ``LABEL_DISAGREEMENT_MAX``, beside the
    embeddings' RMS error and the first-round decisions at ``thr`` that
    differ; prints the margin (the share of edges whose distance lies
    within the RMS error of the threshold). Returns the disagreement."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.utils.parity import (
        label_disagreement,
        pair_disagreement,
    )

    emb_rms = rms_rel_err(*(torch.as_tensor(e) for e in emb))
    d_k, d_p = d
    flips = float(((d_k < thr) != (d_p < thr)).mean())
    margin = float((np.abs(d_p - thr) <= emb_rms * abs(thr)).mean())
    dis = label_disagreement(*maps)
    objects = ("" if gt is None else
               f"; pair disagreement with the scene's objects "
               f"{pair_disagreement(maps[0], gt):.5f} (plain "
               f"{pair_disagreement(maps[1], gt):.5f})")
    print(f"trained weights, {label} at threshold {thr:.6f}: "
          f"{int(maps[0].max()) + 1} clusters (plain "
          f"{int(maps[1].max()) + 1}); embeddings RMS rel err "
          f"{emb_rms:.3e} (max {TOL_EMB_RMS}); first-round decisions that "
          f"differ {flips:.5f} of {d_k.size} edges (max {EDGE_FLIPS_MAX}); "
          f"margin: {margin:.5f} of the edges lie within the RMS error of "
          f"the threshold; label disagreement {dis:.5f} (gate "
          f"{LABEL_DISAGREEMENT_MAX}){objects}")
    require(emb_rms <= TOL_EMB_RMS,
            f"trained {label}: embeddings RMS rel err {emb_rms}")
    require(flips <= EDGE_FLIPS_MAX,
            f"trained {label}: {flips} of the merge decisions differ")
    require(dis <= LABEL_DISAGREEMENT_MAX,
            f"trained {label}: label disagreement {dis} > "
            f"{LABEL_DISAGREEMENT_MAX}")
    return dis


def trained_slice(ex, label, scene, ds, dcfg, edges_d, valid_d, valid,
                  region_map, thr, max_rounds=8, on=()):
    """``segment_scene_device`` with the region map (the merged map through
    K9) at ``thr``, on the kernels (``on`` required launched, K9
    included) and on the plain versions, held by ``parity_gate``."""
    import torch

    n_pts = scene.regions.num_points

    def run():
        out = ex.segment_scene_device(
            scene, dcfg, edges_d, valid_d,
            num_regions=scene.regions.num_regions, max_rounds=max_rounds,
            device_scene=ds, region_map=region_map, threshold=thr,
            with_embeddings=True)
        torch.cuda.synchronize()
        return out

    out_k, launches = counted(run)
    require_launches(launches, tuple(on) + ("label_lookup",), ("int4_dot",),
                     label)
    with plain_versions():
        out_p = run()
    dis = parity_gate(
        label, thr, (out_k[5][:n_pts], out_p[5][:n_pts]),
        (out_k[0].cpu().numpy()[valid], out_p[0].cpu().numpy()[valid]),
        (out_k[3].cpu().numpy(), out_p[3].cpu().numpy()),
        None if scene.object_of_region is None
        else scene.object_of_region[scene.labels])
    del out_k, out_p
    torch.cuda.empty_cache()
    return dis, launches


def padded_edges(scene, dev):
    """The scene's RAG edges padded to a multiple of 2048 rows, with the
    mask of the real ones: as numpy and on ``dev``."""
    import numpy as np
    import torch

    edges = scene.rag.edges.astype(np.int32)
    pad = (-len(edges)) % 2048
    edges = np.concatenate([edges, np.zeros((pad, 2), np.int32)])
    valid = np.arange(len(edges)) < len(scene.rag.edges)
    return (edges, valid, torch.from_numpy(edges).to(dev),
            torch.from_numpy(valid).to(dev))


def trained_walk_scene(dev, trained, thr, walk):
    """The first serving-walk scene (2048², 8192 regions) with the trained
    flagship in w8a8 at ``thr``: ``process_scene`` as the walk serves it
    (the merged map expanded on the host), then ``segment_scene_device``
    with the scene's region map on the same staged scene (K9 at 2048², R
    8192), each on the kernels and on the plain versions, held by
    ``parity_gate``. Returns the disagreements and the second run's
    launches."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.config import Config, DataConfig, MergeConfig
    from deepmerge_tpu_torch.geodata.ingest import load_scene
    from deepmerge_tpu_torch.infer.driver import prestage_scene, process_scene
    from deepmerge_tpu_torch.train.sampler import stage_scene

    images, shps, counts = walk
    name = sorted(counts)[0]
    scene = load_scene(
        os.path.join(images, f"{name}.tif"), os.path.join(shps, f"{name}.shp"),
        os.path.join(shps, name, "PointsGCS.shp"),
        os.path.join(shps, name, "lines.shp"), name=name,
        labels=np.load(os.path.join(shps, f"{name}_labels.npy")))
    ex = trained_extractor(dev, trained, SERVE_BATCH, "w8a8")
    cfg = Config(model=ex.model.cfg,
                 data=DataConfig(max_window=512, eval_batch_size=SERVE_BATCH),
                 merge=MergeConfig(engine="device", threshold=thr))
    ds = stage_scene(scene, cfg.data, dev)
    prestage_scene(ex, scene, ds, cfg.data, max(cfg.merge.edge_batch, 1))

    def run():
        return process_scene(cfg, scene, extractor=ex, device_scene=ds,
                             log_fn=lambda *_: None)

    emb_k, simi_k, res_k = run()
    with plain_versions():
        emb_p, simi_p, res_p = run()
    results = {"walk scene": parity_gate(
        f"walk {name} (process_scene, w8a8)", thr, (emb_k, emb_p),
        (simi_k, simi_p), (res_k.label_map(scene), res_p.label_map(scene)))}
    _, valid, edges_d, valid_d = padded_edges(scene, dev)
    region_map = torch.from_numpy(scene.labels).to(dev)
    results["walk scene, device map"], launches = trained_slice(
        ex, f"walk {name} (segment_scene_device with its region map, w8a8)",
        scene, ds, cfg.data, edges_d, valid_d, valid, region_map, thr,
        max_rounds=cfg.merge.max_rounds, on=Q8_PATH)
    del ex, ds
    torch.cuda.empty_cache()
    return results, launches


def trained_parity_phase(dev, card, scene, ds, dcfg, edges_d, valid_d,
                         valid, region_map, walk):
    """Phase 8: the parity bar on trained weights. Trains the flagship on
    the slice's scene (``train_trusted``), calibrates an absolute
    threshold on a second scene (``calibrated_threshold``), then runs the
    v3 bf16, w8a8 and w8a8+attn slices at that threshold, and the first
    serving-walk scene (``trained_walk_scene``), on the kernels and on the
    plain versions, each gated by ``parity_gate``; then v5 trained and
    calibrated the same way, its w8a8 slice gated too. Returns the
    disagreements, the flagship's weights and threshold, and the launches
    of the walk scene's device-map run."""
    import torch

    from deepmerge_tpu_torch.config import ModelConfig

    t_phase = time.perf_counter()
    trained = train_trusted(dev, scene, ModelConfig())
    thr = calibrated_threshold(dev, trained, dcfg)
    kernels = {"": ("patch_resize", "fused_block", "fused_block_chain"),
               "w8a8": Q8_PATH,
               "w8a8+attn": ("patch_resize", "fused_block_q8_attn",
                             "fused_block_chain_q8_attn")}
    results = {}
    for label, quantize in (("bf16", ""), ("w8a8", "w8a8"),
                            ("w8a8+attn", "w8a8+attn")):
        ex = trained_extractor(dev, trained, dcfg.eval_batch_size, quantize)
        results[label], _ = trained_slice(
            ex, f"v3 {label} slice", scene, ds, dcfg, edges_d, valid_d,
            valid, region_map, thr, on=kernels[quantize])
        del ex
    walk_results, walk_launches = trained_walk_scene(dev, trained, thr, walk)
    results.update(walk_results)
    # v5 (the designed-feature token in the sequence) trained and
    # calibrated the same way: its own weights and threshold
    v5 = train_trusted(dev, scene, ModelConfig(variant="v5"))
    thr5 = calibrated_threshold(dev, v5, dcfg, variant="v5")
    ex = trained_extractor(dev, v5, dcfg.eval_batch_size, "w8a8",
                           variant="v5")
    results["v5 w8a8"], _ = trained_slice(
        ex, "v5 w8a8 slice", scene, ds, dcfg, edges_d, valid_d, valid,
        region_map, thr5, on=Q8_PATH)
    del ex, v5
    torch.cuda.empty_cache()
    print(f"trained-weight parity phase: {time.perf_counter() - t_phase:.1f} "
          f"s on {card}; label disagreements {results}")
    return results, trained, thr, walk_launches


def free_port():
    """A free TCP port on this machine, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def same_partition(a, b):
    """The label disagreement of two merged maps (0 when equal: both are
    dense ids in order of each cluster's smallest region id)."""
    import numpy as np

    from deepmerge_tpu_torch.utils.parity import label_disagreement

    return 0.0 if np.array_equal(a, b) else label_disagreement(a, b)


def trained_model(trained, quantize="w8a8"):
    """The flagship v3 in ``quantize`` with phase 8's trained weights."""
    import warnings

    from deepmerge_tpu_torch.config import ModelConfig
    from deepmerge_tpu_torch.models.s2former import S2Former

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = S2Former(ModelConfig(quantize=quantize))
    model.load_state_dict(trained, strict=True)
    return model


def median_s(fn, reps=3):
    """Median host time of ``fn()`` (which synchronizes) and its times."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times), times


def strip_capture(staged_and_emb):
    """A context in which ``extract_and_merge_sharded`` hands each strip's
    staging and embeddings to ``staged_and_emb`` as it makes them."""
    from deepmerge_tpu_torch.parallel import distributed

    embed = distributed._embed_strip

    def capture(*args):
        emb = embed(*args)
        staged_and_emb.append((args[1], args[2], emb))
        return emb

    return mock.patch.object(distributed, "_embed_strip", capture)


Q8_PATH = ("patch_resize", "fused_block_q8", "fused_block_chain_q8")


def scale_out_rank(rank, world, root):
    """One rank of the two-rank check, in its own process on the one card
    (gloo, CUDA tensors): ``extract_and_merge_sharded`` on two strips,
    ``process_scene(mesh=...)`` and four steps of the data-parallel
    trainer; what it saw goes to ``<root>/rank<rank>.pkl``."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from deepmerge_tpu_torch.config import Config, MergeConfig
    from deepmerge_tpu_torch.geodata.synthetic import (
        generate_scene,
        make_training_pairs,
    )
    from deepmerge_tpu_torch.infer import driver
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.parallel import distributed
    from deepmerge_tpu_torch.parallel.mesh import (
        make_mesh,
        replicate,
        shard_rows,
    )
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.sampler import PairSampler

    from deepmerge_tpu_torch.models.s2former import S2Former

    with open(os.path.join(root, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    dev = torch.device(spec["device"])
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{spec['port']}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(devices=dev)
        out = {}
        scene = generate_scene(**spec["scene"])
        model = S2Former(spec["mcfg"])
        model.load_state_dict(torch.load(
            os.path.join(root, "trained.pt"), map_location="cpu"))
        dcfg, thr, tcfg = spec["dcfg"], spec["thr"], spec["tcfg"]
        ex = FeatureExtractor(model, mesh=mesh,
                              batch_size=dcfg.eval_batch_size)

        def sharded():
            res = distributed.extract_and_merge_sharded(
                None, scene, dcfg, mesh, threshold=thr, max_rounds=8,
                extractor=ex)
            torch.cuda.synchronize()
            return res

        strips = []
        torch.cuda.reset_peak_memory_stats(dev)
        with strip_capture(strips):
            res, out["sharded_launches"] = counted(sharded)
        staged, s, emb = strips[0]
        out.update(sharded_labels=res.region_to_cluster,
                   sharded_rounds=res.rounds,
                   tile_bytes=staged.tiles[s].nbytes, points=emb.shape[0],
                   peak_sharded=torch.cuda.max_memory_allocated(dev))
        out["sharded_s"] = median_s(sharded)

        cfg = Config(model=ex.model.cfg, data=dcfg, merge=MergeConfig(
            engine="device", threshold=thr, max_rounds=8))

        def scene_run():
            return driver.process_scene(cfg, scene, extractor=ex, mesh=mesh,
                                        log_fn=lambda *_: None)

        (_, _, res), out["scene_launches"] = counted(scene_run)
        out["scene_labels"] = res.region_to_cluster
        out["scene_s"] = median_s(scene_run)
        del ex, model
        torch.cuda.empty_cache()

        # four steps of the data-parallel trainer, this rank's half of
        # each batch
        pairs = tcfg.data.batch_size
        pos, neg = make_training_pairs(scene)
        sampler = PairSampler(scene, pos, neg, tcfg.data, dev)
        state = loop.create_train_state(tcfg, len(sampler) // pairs,
                                        device=dev)
        replicate(state.model, mesh)
        step = loop.make_train_step(tcfg, mesh)
        batches = sampler.epoch_batches(spec["epoch_seed"], pairs,
                                        rows=shard_rows(pairs, mesh))

        def four_steps():
            nonlocal state
            losses, times = [], []
            for _, batch in zip(range(4), batches):
                t = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t)
            return losses, times

        torch.cuda.reset_peak_memory_stats(dev)
        (losses, times), out["train_launches"] = counted(four_steps)
        out.update(losses=losses, step_s=times,
                   peak_train=torch.cuda.max_memory_allocated(dev))
        # a checksum of every parameter, rank 0's broadcast to every rank
        mine = torch.stack([p.detach().double().sum()
                            for p in state.model.parameters()])
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        out["params_identical"] = bool(torch.equal(mine, theirs))
        out["checksum"] = float(mine.abs().sum())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def scale_out_phase(dev, card, scene, ds, dcfg, edges_d, valid_d,
                    region_map, trained, thr, walk):
    """Phase 9, scale-out, on phase 8's trained weights and threshold, the
    flagship v3 in w8a8. World size 1 on NCCL, in this process:
    ``extract_and_merge_sharded``, ``process_scene(mesh=...)`` and
    ``process_folder(mesh=...)`` over the walk's scenes, each partition
    held to the single-device one on the same kernels at the parity bar
    (0 expected), K1 and K4 launched and nothing else; times beside the
    single-device split path and the fused ``segment_scene_device``. Then
    two ranks in two processes on the one card over gloo: the sharded
    extract-and-merge on two strips and ``process_scene(mesh=...)`` held
    to the same partition, each rank's strip tile and peak memory, and four
    steps of the data-parallel trainer (60 pairs a rank) against four
    single-device steps from the same weights and batches, its parameters
    the same on both ranks. Returns the launch counts of its main-path
    runs."""
    import multiprocessing
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from deepmerge_tpu_torch.config import (
        Config,
        DataConfig,
        MergeConfig,
        ModelConfig,
    )
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs
    from deepmerge_tpu_torch.infer import driver
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.infer.merge import merge_scene_device
    from deepmerge_tpu_torch.parallel import distributed
    from deepmerge_tpu_torch.parallel.mesh import make_mesh
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.sampler import PairSampler

    t_phase = time.perf_counter()
    r = scene.regions.num_regions
    model = trained_model(trained)
    mcfg = model.cfg
    off = [k for k in counters() if k not in Q8_PATH]
    runs = []

    def held(launches, what):
        require_launches(launches, Q8_PATH, off, what)
        runs.append(launches)

    # the single-device references on the same kernels
    ex = FeatureExtractor(model, batch_size=dcfg.eval_batch_size, device=dev)

    def fused():
        out = ex.segment_scene_device(
            scene, dcfg, edges_d, valid_d, num_regions=r, max_rounds=8,
            device_scene=ds, region_map=region_map, threshold=thr)
        torch.cuda.synchronize()
        return out

    def split():
        emb = ex.extract_scene_device(scene, dcfg, device_scene=ds)
        res = merge_scene_device(scene, emb, threshold=thr, max_rounds=8)
        torch.cuda.synchronize()
        return emb, res

    out = fused()
    want_map = out[3].cpu().numpy()
    emb_single, res_split = split()
    require(same_partition(res_split.label_map(scene), want_map) == 0.0,
            "the single-device split and fused paths disagree")
    print(f"scale-out, single device (w8a8, trained weights, threshold "
          f"{thr:.6f}): {int(out[4])} clusters after {int(out[2])} rounds")

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(devices=dev)
        mex = FeatureExtractor(model, batch_size=dcfg.eval_batch_size,
                               mesh=mesh)

        def sharded():
            res = distributed.extract_and_merge_sharded(
                None, scene, dcfg, mesh, threshold=thr, max_rounds=8,
                extractor=mex)
            torch.cuda.synchronize()
            return res

        strips = []
        with strip_capture(strips):
            res, launches = counted(sharded)
        print(f"world 1 (NCCL), extract_and_merge_sharded launches: "
              f"{launches}")
        held(launches, "the world-1 sharded extract-and-merge")
        emb = strips[0][2]
        err = (emb - emb_single).abs()
        dis = same_partition(res.label_map(scene), want_map)
        print(f"world 1, extract_and_merge_sharded: {res.num_clusters} "
              f"clusters after {res.rounds} rounds; embeddings against "
              f"extract_scene_device: max |diff| {float(err.max()):.3e}, "
              f"RMS rel err {rms_rel_err(emb, emb_single):.3e}; label "
              f"disagreement with segment_scene_device {dis:.5f} (gate "
              f"{LABEL_DISAGREEMENT_MAX}, 0 expected)")
        require(dis <= LABEL_DISAGREEMENT_MAX,
                f"world-1 sharded partition: label disagreement {dis}")
        for label, fn in (("world-1 extract_and_merge_sharded", sharded),
                          ("single-device split path (extract_scene_device "
                           "+ merge_scene_device)", split),
                          ("fused segment_scene_device", fused)):
            med, times = median_s(fn)
            print(f"scale-out time, {label}: median {med * 1e3:.1f} ms of "
                  f"{[round(x * 1e3, 1) for x in times]} ms on {card}")
        med, _ = median_s(lambda: distributed.stage_scene_shards(scene, dcfg,
                                                                 1))
        print(f"  of which the host staging of the strips "
              f"(stage_scene_shards): {med * 1e3:.1f} ms")

        cfg = Config(model=model.cfg, data=dcfg, merge=MergeConfig(
            engine="device", threshold=thr, max_rounds=8))
        (_, _, res), launches = counted(lambda: driver.process_scene(
            cfg, scene, extractor=mex, mesh=mesh, log_fn=lambda *_: None))
        held(launches, "the world-1 process_scene")
        dis = same_partition(res.label_map(scene), want_map)
        print(f"world 1, process_scene(mesh): {res.num_clusters} clusters, "
              f"label disagreement {dis:.5f}; launches {launches}")
        require(dis <= LABEL_DISAGREEMENT_MAX,
                f"world-1 process_scene partition: label disagreement {dis}")

        # the serving walk through the mesh, then on one device
        images, shps, counts = walk
        wcfg = Config(model=model.cfg,
                      data=DataConfig(max_window=512,
                                      eval_batch_size=SERVE_BATCH),
                      merge=MergeConfig(engine="device", threshold=thr))
        maps, stores = {}, {}
        for label, kw in (
                ("mesh", dict(mesh=mesh, extractor=FeatureExtractor(
                    model, batch_size=SERVE_BATCH, mesh=mesh))),
                ("single", dict(extractor=FeatureExtractor(
                    model, batch_size=SERVE_BATCH, device=dev)))):
            t = time.perf_counter()
            with feature_stores(stores):
                done, launches = counted(lambda: driver.process_folder(
                    wcfg, images, shps, log_fn=lambda *_: None,
                    write_labelmaps=True, **kw))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            require(done == sorted(counts), f"{label} walk: done {done}")
            maps[label] = walk_maps(shps, done, wcfg.model.name)
            print(f"world 1, process_folder ({label}): {len(done)} scenes in "
                  f"{wall:.3f} s on {card}; launches {launches}")
            if label == "mesh":
                held(launches, "the world-1 process_folder")
        for name in sorted(counts):
            dis = same_partition(maps["mesh"][name], maps["single"][name])
            print(f"  {name}: {int(maps['mesh'][name].max()) + 1} clusters, "
                  f"label disagreement with the single-device walk "
                  f"{dis:.5f}")
            require(dis <= LABEL_DISAGREEMENT_MAX,
                    f"world-1 walk {name}: label disagreement {dis}")
        del mex
    finally:
        dist.destroy_process_group()
    del ex, model
    torch.cuda.empty_cache()

    # two ranks on the one card over gloo: a check of the collectives
    # across processes, not a scaling number
    tcfg = Config(model=ModelConfig(),
                  data=DataConfig(batch_size=TRAIN_PAIRS, max_window=512))
    root = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = []
    try:
        torch.save(trained, os.path.join(root, "trained.pt"))
        epoch_seed = 777
        with open(os.path.join(root, "spec.pkl"), "wb") as f:
            pickle.dump(dict(port=free_port(), dcfg=dcfg, thr=thr,
                             epoch_seed=epoch_seed, mcfg=mcfg, tcfg=tcfg,
                             scene=SCENE, device=str(dev)), f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=scale_out_rank, args=(k, 2, root))
                 for k in range(2)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        wall = time.perf_counter() - t
        require(all(p.exitcode == 0 for p in procs),
                f"two-rank check: exit codes {[p.exitcode for p in procs]}")
        ranks = []
        for k in range(2):
            with open(os.path.join(root, f"rank{k}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    print(f"two ranks on one card (two processes, gloo): {wall:.1f} s with "
          "start-up")
    whole = ds.padded.numel() * ds.padded.element_size()
    for k, o in enumerate(ranks):
        print(f"  rank {k} launches: sharded {o['sharded_launches']}; "
              f"training {o['train_launches']}")
        for what in ("sharded", "scene"):
            require_launches(o[f"{what}_launches"], Q8_PATH, off,
                             f"rank {k}'s {what} run")
        require_launches(o["train_launches"],
                         ("patch_resize", "fused_attention_train"),
                         [c for c in off if c != "fused_attention_train"],
                         f"rank {k}'s training steps")
        for what in ("sharded", "scene"):
            labels = o[f"{what}_labels"]
            dis = same_partition(labels[scene.labels], want_map)
            print(f"  rank {k}, {what}: label disagreement with the single "
                  f"device {dis:.5f}; {o[what + '_s'][0] * 1e3:.1f} ms median "
                  f"(two processes on one card)")
            require(dis <= LABEL_DISAGREEMENT_MAX,
                    f"rank {k} {what}: label disagreement {dis}")
        print(f"  rank {k}: strip tile {o['tile_bytes']} bytes against the "
              f"whole padded scene's {whole} ({o['points']} points); peak "
              f"memory {o['peak_sharded'] / 2**30:.2f} GiB in the sharded "
              f"run, {o['peak_train'] / 2**30:.2f} GiB training")
    require(ranks[0]["params_identical"] and ranks[1]["params_identical"],
            "the data-parallel ranks' parameters differ")

    # the same four steps on one device, whole batches
    pos, neg = make_training_pairs(scene)
    sampler = PairSampler(scene, pos, neg, tcfg.data, dev)
    state = loop.create_train_state(tcfg, len(sampler) // TRAIN_PAIRS,
                                    device=dev)
    step = loop.make_train_step(tcfg)
    want, times = [], []
    for _, batch in zip(range(4), sampler.epoch_batches(epoch_seed,
                                                        TRAIN_PAIRS)):
        t = time.perf_counter()
        state, m = step(state, batch)
        want.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
    del state
    torch.cuda.empty_cache()
    want = np.asarray(want)
    print(f"  one device, the same four steps ({TRAIN_PAIRS} pairs, host "
          f"batches): {[round(x * 1e3, 1) for x in times]} ms on {card}")
    for k, o in enumerate(ranks):
        rel = np.abs(np.asarray(o["losses"]) - want) / np.abs(want)
        print(f"  rank {k}, data-parallel trainer ({TRAIN_PAIRS // 2} pairs "
              f"a rank): losses "
              f"{o['losses']} against one device's {want.tolist()}, rel diff "
              f"{rel.tolist()} (step 0 max {TOL_TRAIN_LOSS0}, all max "
              f"{TOL_TRAIN_LOSS}); steps "
              f"{[round(x * 1e3, 1) for x in o['step_s']]} ms (two "
              f"processes on one card); parameters the same on both "
              f"ranks (checksum {o['checksum']:.6e})")
        require(rel[0] <= TOL_TRAIN_LOSS0 and rel.max() <= TOL_TRAIN_LOSS,
                f"rank {k}: data-parallel losses differ: {rel}")
    runs.extend(tensor_parallel_case(dev, card, scene, ds, dcfg, trained,
                                     thr))
    print(f"scale-out phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return runs


TP_RANKS = 2
TP_STEPS = 2


def tensor_parallel_rank(rank, world, root):
    """One rank of the tensor-parallel case, in its own process on the one
    card (gloo, CUDA tensors), a (1, ``world``) mesh: the flagship v3 in
    bf16 built for the mesh on its ``shard_params`` of phase 8's weights,
    the slice's embeddings through ``extract_scene_device``, then
    ``TP_STEPS`` steps of ``make_train_step(cfg, mesh)``; what it saw goes
    to ``<root>/tp<rank>.pkl``."""
    import pickle

    import torch
    import torch.distributed as dist

    from deepmerge_tpu_torch.config import ModelConfig
    from deepmerge_tpu_torch.geodata.synthetic import (
        generate_scene,
        make_training_pairs,
    )
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.models.s2former import S2Former
    from deepmerge_tpu_torch.parallel.mesh import make_mesh, shard_params
    from deepmerge_tpu_torch.parallel.mesh import _tp_split
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.sampler import PairSampler

    with open(os.path.join(root, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    dev = torch.device(spec["device"])
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{spec['port']}", world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_data=1, n_model=world, devices=dev)
        trained = torch.load(os.path.join(root, "trained.pt"),
                             map_location="cpu")
        model = S2Former(ModelConfig(), mesh)
        model.load_state_dict(shard_params(trained, mesh), strict=True)
        scene = generate_scene(**spec["scene"])
        ex = FeatureExtractor(model, batch_size=spec["dcfg"].eval_batch_size,
                              device=dev)

        def forward():
            emb = ex.extract_scene_device(scene, spec["dcfg"])
            torch.cuda.synchronize()
            return emb

        out = {}
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        emb, out["forward_launches"] = counted(forward)
        out.update(forward_s=time.perf_counter() - t, emb=emb.cpu(),
                   peak_forward=torch.cuda.max_memory_allocated(dev))
        del ex, model, emb
        torch.cuda.empty_cache()

        tcfg = spec["tcfg"]
        pos, neg = make_training_pairs(scene)
        sampler = PairSampler(scene, pos, neg, tcfg.data, dev)
        state = loop.create_train_state(
            tcfg, len(sampler) // tcfg.data.batch_size, state_dict=trained,
            device=dev, mesh=mesh)
        step = loop.make_train_step(tcfg, mesh)
        batches = sampler.epoch_batches(spec["epoch_seed"],
                                        tcfg.data.batch_size)

        def steps():
            nonlocal state
            losses, times = [], []
            for _, batch in zip(range(TP_STEPS), batches):
                t = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                times.append(time.perf_counter() - t)
            return losses, times

        torch.cuda.reset_peak_memory_stats(dev)
        (losses, times), out["train_launches"] = counted(steps)
        out.update(losses=losses, step_s=times,
                   peak_train=torch.cuda.max_memory_allocated(dev))
        # the replicated parameters, rank 0's checksum broadcast to all
        mine = torch.stack([p.detach().double().sum() for name, p in
                            state.model.named_parameters()
                            if _tp_split(name) is None])
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        out["replicated_identical"] = bool(torch.equal(mine, theirs))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"tp{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def tensor_parallel_case(dev, card, scene, ds, dcfg, trained, thr):
    """Phase 9's tensor-parallel case: ``TP_RANKS`` ranks in as many
    processes on the one card over gloo (``tensor_parallel_rank``), the
    flagship v3 at full width (embed 768, 12 heads: 6 of width 64 a rank)
    on phase 8's weights. Each rank's embeddings of the slice's points
    against the single-device forward on the plain versions (RMS error and
    the first-round decisions at phase 8's threshold, as the slices are
    held), K7 launched on the local heads and no block kernel; its training
    steps (K6 on the local heads) against one device's steps from the same
    weights and batches, by phase 7's loss bars, its replicated parameters
    identical on both ranks. A check of the split and its collectives, not
    a scaling number. Returns the ranks' launch counts."""
    import multiprocessing
    import pickle

    import numpy as np
    import torch

    from deepmerge_tpu_torch.config import Config, DataConfig, ModelConfig
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs
    from deepmerge_tpu_torch.ops.segment import edge_distances, segment_mean
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.sampler import PairSampler

    tcfg = Config(model=ModelConfig(),
                  data=DataConfig(batch_size=TRAIN_PAIRS, max_window=512))
    epoch_seed = 778
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs = []
    try:
        torch.save(trained, os.path.join(root, "trained.pt"))
        with open(os.path.join(root, "spec.pkl"), "wb") as f:
            pickle.dump(dict(port=free_port(), dcfg=dcfg, tcfg=tcfg,
                             epoch_seed=epoch_seed, scene=SCENE,
                             device=str(dev)), f)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=tensor_parallel_rank,
                             args=(k, TP_RANKS, root))
                 for k in range(TP_RANKS)]
        t = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        wall = time.perf_counter() - t
        require(all(p.exitcode == 0 for p in procs),
                f"tensor-parallel ranks: exit codes "
                f"{[p.exitcode for p in procs]}")
        ranks = []
        for k in range(TP_RANKS):
            with open(os.path.join(root, f"tp{k}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    print(f"tensor parallelism, {TP_RANKS} ranks on one card (gloo, n_model "
          f"{TP_RANKS}, {12 // TP_RANKS} heads of 64 a rank): {wall:.1f} s "
          "with start-up")

    # the single-device references: the forward on the plain versions,
    # then the same steps from the same weights and batches
    ex = trained_extractor(dev, trained, dcfg.eval_batch_size)
    with plain_versions():
        emb_p = ex.extract_scene_device(scene, dcfg, device_scene=ds)
    del ex
    r = scene.regions.num_regions
    pr = torch.as_tensor(scene.regions.point_region, device=dev)
    edges = torch.as_tensor(scene.rag.edges, device=dev)

    def distances(emb):
        remb = segment_mean(emb.to(dev, torch.float32), pr, r)
        return edge_distances(remb, edges).cpu().numpy()

    d_p = distances(emb_p)
    pos, neg = make_training_pairs(scene)
    sampler = PairSampler(scene, pos, neg, tcfg.data, dev)
    state = loop.create_train_state(tcfg, len(sampler) // TRAIN_PAIRS,
                                    state_dict=trained, device=dev)
    step = loop.make_train_step(tcfg)
    want = []
    for _, batch in zip(range(TP_STEPS),
                        sampler.epoch_batches(epoch_seed, TRAIN_PAIRS)):
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    want = np.asarray(want)
    blocks = sum(ModelConfig().depth)
    chunks = -(-scene.regions.num_points // dcfg.eval_batch_size)
    launches = []
    for k, o in enumerate(ranks):
        fl, tl = o["forward_launches"], o["train_launches"]
        print(f"  rank {k} launches: forward {fl}; training {tl}")
        require_launches(fl, ("patch_resize", "attention_qkv"),
                         [c for c in fl if c not in ("patch_resize",
                                                     "attention_qkv")],
                         f"tensor-parallel rank {k}'s forward")
        require(fl["attention_qkv"] == blocks * chunks,
                f"rank {k}: K7 launched {fl['attention_qkv']} times, want "
                f"{blocks} a chunk")
        require_launches(tl, ("patch_resize", "fused_attention_train"),
                         [c for c in tl if c not in (
                             "patch_resize", "fused_attention_train")],
                         f"tensor-parallel rank {k}'s training")
        require(tl["fused_attention_train"] == blocks * TP_STEPS,
                f"rank {k}: K6 launched {tl['fused_attention_train']} "
                f"times, want {blocks} a step")
        launches += [fl, tl]
        emb_rms = rms_rel_err(o["emb"], emb_p.cpu())
        d = distances(o["emb"])
        flips = float(((d < thr) != (d_p < thr)).mean())
        rel = np.abs(np.asarray(o["losses"]) - want) / np.abs(want)
        print(f"  rank {k}: embeddings against the single-device plain "
              f"forward: RMS rel err {emb_rms:.3e} (max {TOL_EMB_RMS}); "
              f"first-round decisions at {thr:.6f} that differ {flips:.5f} "
              f"of {d.size} edges (max {EDGE_FLIPS_MAX}); forward "
              f"{o['forward_s']:.2f} s, peak {o['peak_forward'] / 2**30:.2f}"
              f" GiB; training losses {o['losses']} against one device's "
              f"{want.tolist()}, rel diff {rel.tolist()} (step 0 max "
              f"{TOL_TRAIN_LOSS0}, all max {TOL_TRAIN_LOSS}); steps "
              f"{[round(x * 1e3, 1) for x in o['step_s']]} ms, peak "
              f"{o['peak_train'] / 2**30:.2f} GiB (two processes on one "
              f"card, gloo); replicated parameters identical on both ranks: "
              f"{o['replicated_identical']}")
        require(emb_rms <= TOL_EMB_RMS,
                f"tensor-parallel rank {k}: embeddings RMS rel err {emb_rms}")
        require(flips <= EDGE_FLIPS_MAX,
                f"tensor-parallel rank {k}: {flips} of the decisions differ")
        require(rel[0] <= TOL_TRAIN_LOSS0 and rel.max() <= TOL_TRAIN_LOSS,
                f"tensor-parallel rank {k}: losses differ: {rel}")
        require(o["replicated_identical"], "tensor-parallel ranks' "
                "replicated parameters differ")
    return launches


# ---------------------------------------------------------------- phase 10

VIT_SCALES = (28, 56, 112, 224)
VIT_TRAIN_STEPS = 4
TRIPLET_BATCH = 8     # triplets in the legacy batch (3 contexts each)
TILE_POINTS = 128     # the scene's first points, exported at window 224
TILE_SHARD = 64
LEGACY_MIN_ACC = 0.2  # one epoch of each legacy trainer: twice chance


def check_vit_patches(dev, scene, ds):
    """Phase 10, K1 at the vit sides against its plain version on the card:
    the fused patch kernel bit-exact on every slot of the vit slice's
    points whose cap is at most 256 (out 28, 56, 112, 224; the slice's
    chunks of 1024), and at a cap of 256 at every side; K1's gather
    bit-exact on the slots whose cap is above 256. Each fused slot of the
    slice's first chunk timed beside its plain version."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.ops import patches
    from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
    from deepmerge_tpu_torch.ops.kernels import window_gather as wg

    t_phase = time.perf_counter()
    centers = torch.as_tensor(ds.points_yx, dtype=torch.int32, device=dev)
    c = ds.padded.shape[-1]

    def fused_cases(padded, caps, inner, obj):
        """(first chunk?, patch_resize's arguments) for every fused slot
        and chunk of 1024 points."""
        scales = patches.adaptive_scales(inner, obj, VIT_SCALES,
                                         device=dev)[0]
        pad = patches.scene_pad(caps, ds.channels)
        return [(i == 0, (padded, centers[i : i + 1024],
                          scales[i : i + 1024, slot], cap, out, pad,
                          ds.channels, torch.bfloat16))
                for slot, (cap, out) in enumerate(zip(caps, VIT_SCALES))
                if cap <= pr.MAX_CAP
                for i in range(0, centers.shape[0], 1024)]

    caps256 = (256,) * 4
    padded256 = patches.pad_scene_device(
        torch.from_numpy(np.ascontiguousarray(scene.image)).to(dev),
        patches.scene_pad(caps256, ds.channels), c)
    cases = {"vit slice": fused_cases(ds.padded, ds.caps, ds.point_inner,
                                      ds.point_object),
             "cap 256": fused_cases(padded256, caps256, 2 * ds.point_inner,
                                    2 * ds.point_object)}
    worst = 0.0
    for label, args in cases.items():
        for _, a in args:
            got = pr.patch_resize(*a, trusted_origins=True)
            want = pr.patch_resize_ref(*a)
            differ = int((got.float() != want.float()).sum())
            if differ:
                print(f"  K1 {label} out {a[4]} cap {a[3]}: {differ} of "
                      f"{want.numel()} codes differ")
            worst = max(worst, abs_err(got, want))
        sides = sorted({(a[4], a[3]) for _, a in args})
        print(f"K1 patch_resize at the vit sides, {label}: (out, cap) "
              f"{sides}, {len(args)} launches, max |err| {worst} (tol "
              f"{TOL_PATCHES})")
    require(worst <= TOL_PATCHES, f"patch_resize differs from its plain "
            f"version at the vit sides: {worst}")
    for first, a in cases["vit slice"]:
        if not first:
            continue
        plan = pr.patch_resize_plan(a[3], a[4], c)
        ms = cuda_median_ms(lambda: pr.patch_resize(*a, trusted_origins=True))
        plain_ms = cuda_median_ms(lambda: pr.patch_resize_ref(*a), reps=5)
        print(f"  out {a[4]} cap {a[3]}, {a[1].shape[0]} points (tiles of "
              f"{plan['tile_rows']} rows, {plan['tiles']} a point, the last "
              f"{a[4] - (plan['tiles'] - 1) * plan['tile_rows']} rows): "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms")

    # the float path's gather on the slots whose cap is above 256, and at
    # a cap of 512 (the slice's max_window) on every point
    staged = [(ds.padded, ds.caps,
               [cap for cap in ds.caps if cap > pr.MAX_CAP])]
    caps512 = (512,) * 4
    staged.append((patches.pad_scene_device(
        torch.from_numpy(np.ascontiguousarray(scene.image)).to(dev),
        patches.scene_pad(caps512, ds.channels), c), caps512, [512]))
    worst, calls = 0.0, 0
    for padded, caps, wide in staged:
        scene2d = padded.reshape(padded.shape[0], -1)
        pad = patches.scene_pad(caps, ds.channels)
        for cap in wide:
            rows, cols = cap + wg.ROW_ALIGN, (cap + wg.pixel_align(c)) * c
            for s in range(0, centers.shape[0], 256):
                starts, _, _ = wg.window_starts(centers[s : s + 256], cap,
                                                pad, c)
                worst = max(worst, abs_err(
                    wg.gather_windows(scene2d, starts, rows, cols),
                    wg.gather_windows_ref(scene2d, starts, rows, cols)))
                calls += 1
    print(f"K1 window_gather at the vit slice's caps above {pr.MAX_CAP} "
          f"({staged[0][2]}) and at a cap of 512: {calls} calls, max |err| "
          f"{worst} (tol {TOL_GATHER}); checks "
          f"{time.perf_counter() - t_phase:.1f} s")
    require(worst <= TOL_GATHER, f"window gather differs at the vit caps: "
            f"{worst}")


def vit_training(dev, card, mcfg, scene):
    """Phase 10, vit training: ``train()`` for ``VIT_TRAIN_STEPS`` steps of
    ``TRAIN_PAIRS`` pairs on the slice's scene (K1 only: the vit's blocks
    are plain PyTorch), then single steps timed with the peak memory, then
    four steps from the same weights and batches on the plain versions,
    held to phase 7's loss bars. Returns the training run's launches."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.config import Config, DataConfig, TrainConfig
    from deepmerge_tpu_torch.geodata.synthetic import make_training_pairs
    from deepmerge_tpu_torch.models.s2former import training_model
    from deepmerge_tpu_torch.train import loop
    from deepmerge_tpu_torch.train.driver import train
    from deepmerge_tpu_torch.train.sampler import FusedPairSampler

    root = tempfile.mkdtemp(prefix="chip_smoke_vit_train_")
    try:
        cfg = Config(
            model=mcfg,
            data=DataConfig(patch_sizes=VIT_SCALES, batch_size=TRAIN_PAIRS,
                            max_window=512),
            train=TrainConfig(num_epochs=1, checkpoint_dir=os.path.join(
                root, "ck"), log_dir=os.path.join(root, "logs")))
        log = []
        t = time.perf_counter()
        (state, _), launches = counted(lambda: train(
            cfg, scene=scene, max_steps_per_epoch=VIT_TRAIN_STEPS,
            log_fn=log.append, device=dev))
        torch.cuda.synchronize()
        print(f"training (vit): {VIT_TRAIN_STEPS} steps of {TRAIN_PAIRS} "
              f"pairs in {time.perf_counter() - t:.1f} s ({'; '.join(log)}); "
              f"launches {launches}")
        require(state.step == VIT_TRAIN_STEPS,
                f"trained {state.step} of {VIT_TRAIN_STEPS} steps")
        on = [k for k in ("patch_resize", "window_gather") if launches[k]]
        require("patch_resize" in on, "patch_resize did not run in vit "
                "training")
        require_launches(launches, on, [k for k in launches if k not in on],
                         "vit training")

        pos, neg = make_training_pairs(scene)
        sampler = FusedPairSampler(scene, pos, neg, cfg.data, dev)
        epoch_fn = loop.make_scanned_epoch(cfg, sampler.device_scene)
        arrays = sampler.epoch_arrays(12345, TRAIN_PAIRS)
        step = lambda i: epoch_fn(state, *(a[i : i + 1] for a in arrays))
        step(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(1, 4):
            t = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        print(f"training step (vit, {TRAIN_PAIRS} pairs, forward batch "
              f"{2 * TRAIN_PAIRS}): median {med * 1e3:.1f} ms of "
              f"{[round(x * 1e3, 1) for x in times]} ms -> "
              f"{TRAIN_PAIRS / med:.1f} pairs/s; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on "
              f"{card}")
        del state
        torch.cuda.empty_cache()

        start_sd = init_state_dict(training_model(cfg), seed=cfg.train.seed)
        first = tuple(a[:4] for a in sampler.epoch_arrays(
            cfg.train.seed * 100003 % 2**32, TRAIN_PAIRS))

        def four_steps():
            st = loop.create_train_state(cfg, len(sampler) // TRAIN_PAIRS,
                                         state_dict=start_sd, device=dev)
            return epoch_fn(st, *first)[1].cpu().numpy().astype(np.float64)

        got = four_steps()
        with plain_versions():
            want = four_steps()
        rel = np.abs(got - want) / np.abs(want)
        print(f"training (vit) on the plain versions: losses "
              f"{want.tolist()}, kernels {got.tolist()}, rel diff "
              f"{rel.tolist()} (step 0 max {TOL_TRAIN_LOSS0}, all max "
              f"{TOL_TRAIN_LOSS})")
        require(np.isfinite(got).all() and rel[0] <= TOL_TRAIN_LOSS0
                and rel.max() <= TOL_TRAIN_LOSS,
                f"vit training losses differ from the plain versions': {rel}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def legacy_and_tiles(dev, scene):
    """Phase 10, the legacy harness and the tiles exporter on the card:
    ``train_mlp`` and ``train_gru`` one epoch each on ``synthetic_digits``;
    one ``TripletSampler`` batch (crop 224), its patches bit-exact against
    the plain path, through ``SpatiallyMemorizedNetwork``,
    ``pool_contexts`` and ``triplet_loss``; ``export_class_patches`` of the
    scene's first ``TILE_POINTS`` points at window 224, its shards
    bit-exact against the plain path's and read back by
    ``load_patch_shard``. Returns the launch counts of the triplet batch
    and of the export."""
    import numpy as np
    import torch

    from deepmerge_tpu_torch.config import DataConfig
    from deepmerge_tpu_torch.geodata import tiles
    from deepmerge_tpu_torch.models.legacy import SpatiallyMemorizedNetwork
    from deepmerge_tpu_torch.train.legacy_harness import train_gru, train_mlp
    from deepmerge_tpu_torch.train.losses import triplet_loss
    from deepmerge_tpu_torch.train.sampler import TripletSampler

    quiet = lambda *_: None
    t = time.perf_counter()
    _, acc, losses = train_mlp(epochs=1, device=dev, log_fn=quiet)
    mlp_s = time.perf_counter() - t
    t = time.perf_counter()
    _, gacc, glosses = train_gru(epochs=1, device=dev, log_fn=quiet)
    print(f"legacy: train_mlp 1 epoch {mlp_s:.1f} s, loss {losses[0]:.4f}, "
          f"accuracy {acc:.3f}; train_gru 1 epoch "
          f"{time.perf_counter() - t:.1f} s, loss {glosses[0]:.4f}, "
          f"accuracy {gacc:.3f}")
    require(np.isfinite(losses + glosses).all(), "legacy losses")
    require(min(acc, gacc) > LEGACY_MIN_ACC,
            f"legacy accuracies {acc:.3f} / {gacc:.3f} after one epoch: not "
            f"above {LEGACY_MIN_ACC} (ten classes, chance 0.1)")

    sampler = TripletSampler(scene, DataConfig(max_window=512),
                             crop_size=224, device=dev)
    draw = lambda: next(sampler.epoch_batches(3, TRIPLET_BATCH))
    batch, trip_launches = counted(draw)
    with plain_versions():
        plain = draw()
    worst = max(abs_err(g, w) for k in batch for g, w in
                zip(batch[k], plain[k]))
    print(f"TripletSampler: {TRIPLET_BATCH} triplets x 3 contexts at crop "
          f"224, cap {sampler.device_scene.caps[-1]}; launches "
          f"{trip_launches}; patches against the plain path max |err| "
          f"{worst} (tol {TOL_PATCHES})")
    require(worst <= TOL_PATCHES, f"triplet patches differ: {worst}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = SpatiallyMemorizedNetwork().to(dev).eval()
    with torch.inference_mode():
        pooled = {k: net.pool_contexts(torch.stack([net(p) for p in v],
                                                   dim=1))
                  for k, v in batch.items()}
        loss = triplet_loss(pooled["anchor"], pooled["positive"],
                            pooled["negative"])
    print(f"  SpatiallyMemorizedNetwork embeddings "
          f"{tuple(pooled['anchor'].shape)}, triplet loss {float(loss):.5f}")
    require(bool(torch.isfinite(loss)), "triplet loss is not finite")

    pts = scene.regions.points_yx[:TILE_POINTS]
    ids = scene.object_of_region[scene.regions.point_region[:TILE_POINTS]]
    root = tempfile.mkdtemp(prefix="chip_smoke_tiles_")
    try:
        export = lambda d: tiles.export_class_patches(
            os.path.join(root, d), scene.image, pts, ids, window=224,
            out_size=224, shard_size=TILE_SHARD, device=dev)
        t = time.perf_counter()
        written, tile_launches = counted(lambda: export("kernels"))
        export_s = time.perf_counter() - t
        with plain_versions():
            plain_written = export("plain")
        worst, n = 0.0, 0
        for split, paths in written.items():
            for a, b in zip(paths, plain_written[split]):
                (pa, la), (pb, lb) = (tiles.load_patch_shard(a),
                                      tiles.load_patch_shard(b))
                require(np.array_equal(la, lb), f"{a}: labels differ")
                worst = max(worst, float(np.abs(pa - pb).max()))
                n += len(pa)
        print(f"tiles: {TILE_POINTS} points at window 224 -> "
              f"{sum(map(len, written.values()))} shards ({export_s:.1f} s, "
              f"launches {tile_launches}); {n} patches read back, against "
              f"the plain path max |err| {worst} (tol {TOL_PATCHES})")
        require(n == TILE_POINTS and worst <= TOL_PATCHES,
                f"tiles: {n} patches read back, max |err| {worst}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return trip_launches, tile_launches


def eval_run(repo):
    """Phase 10, ``python -m deepmerge_tpu_torch.eval --calibrate`` at its
    smoke defaults as a subprocess on the card (its logs and checkpoints in
    a temporary directory): exit 0 and a JSON tail that parses."""
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        env = dict(os.environ, PYTHONPATH=repo)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "deepmerge_tpu_torch.eval", "--calibrate",
             "--checkpoint-dir", os.path.join(root, "ck")],
            capture_output=True, text=True, timeout=600, cwd=root, env=env)
        wall = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(proc.returncode == 0, f"eval exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    tail = json.loads(proc.stdout.strip().splitlines()[-1])
    held = [(h["seed"], h["clusters"], h["pair_disagreement"])
            for h in tail["held_out"]]
    print(f"eval (python -m deepmerge_tpu_torch.eval --calibrate, smoke "
          f"defaults, {tail['device']}): exit 0 in {wall:.1f} s, trained "
          f"{tail['epochs']} epochs in {tail['train_seconds']} s, threshold "
          f"{tail['threshold']} (validation disagreement "
          f"{tail['calibration']['val_disagreement']}); held out (seed, "
          f"clusters, pair disagreement): {held}")


def profiling_helpers(dev):
    """Phase 10, ``utils.profiling``: ``sync_time`` and ``rep_probe`` of one
    K4 block launch (B 1024, N 192) beside CUDA events' time of it."""
    from deepmerge_tpu_torch.ops.kernels import fused_block as fb
    from deepmerge_tpu_torch.utils.profiling import rep_probe, sync_time

    x, plist, heads = block_inputs(1024, 192, 1, dev, seed=10)
    qp = fb.quantize_block_params(plist[0])
    run = lambda: fb.fused_block_q8(x, qp, heads)
    events = cuda_ms(run, reps=20)
    wall = sync_time(run, iters=20)
    slope = rep_probe(lambda i: run(), k=16)
    print(f"profiling: one K4 block (B 1024, N 192): CUDA events "
          f"{events:.3f} ms, sync_time {wall:.3f} ms, rep_probe slope "
          f"{slope:.3f} ms")


def family_phase(dev, card, repo, scene, edges_d, valid_d, valid,
                 region_map):
    """Phase 10 (see the module docstring). Returns the launch counts of
    each of its main-path runs: the vit slice, the vit float path, vit
    training, the triplet batch and the tiles export."""
    import warnings

    import torch

    from deepmerge_tpu_torch import DataConfig, ModelConfig
    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.models.s2former import build_model
    from deepmerge_tpu_torch.models.vit import ATTENTION_RANGE
    from deepmerge_tpu_torch.train.sampler import stage_scene

    t_phase = time.perf_counter()
    r = scene.regions.num_regions
    n_edges = int(valid.sum())
    dcfg = DataConfig(patch_sizes=VIT_SCALES, max_window=512,
                      eval_batch_size=1024)
    ds = stage_scene(scene, dcfg, dev)
    print(f"phase 10: the vit slice's caps {ds.caps} at out {VIT_SCALES}")
    check_vit_patches(dev, scene, ds)

    # the vit slice at ViT-B width: embed 768, depth sum(6, 4, 2) = 12,
    # 12 heads, out 100, bf16
    mcfg = ModelConfig(variant="vit", input_image_scales=VIT_SCALES)
    t = time.perf_counter()
    model = build_model(mcfg)
    model.load_state_dict(init_state_dict(mcfg, seed=0), strict=True)
    ex = FeatureExtractor(model, batch_size=dcfg.eval_batch_size, device=dev)
    print(f"vit: {sum(p.numel() for p in model.parameters())} parameters, "
          f"depth {len(model.blocks)}, built in "
          f"{time.perf_counter() - t:.1f} s")

    def run_slice():
        out = ex.segment_scene_device(
            scene, dcfg, edges_d, valid_d, num_regions=r, max_rounds=8,
            device_scene=ds, region_map=region_map)
        torch.cuda.synchronize()
        return out

    t = time.perf_counter()
    out, launches = counted(run_slice)
    print(f"slice (vit) launches: {launches} (first run "
          f"{time.perf_counter() - t:.3f} s)")
    on = ["patch_resize", "label_lookup"] + (
        ["window_gather"] if max(ds.caps) > 256 else [])
    require_launches(launches, on, [k for k in launches if k not in on],
                     "the vit slice")
    chunks = -(-scene.regions.num_points // dcfg.eval_batch_size)
    fused_slots = sum(cap <= 256 for cap in ds.caps)
    require(launches["patch_resize"] == fused_slots * chunks,
            f"patch_resize launched {launches['patch_resize']} times on the "
            f"vit slice, want {fused_slots} a chunk of {chunks}")
    _, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                         scene.labels.shape)
    print(f"slice (vit): {k} clusters after {n_rounds} rounds")
    time_slice(run_slice, "vit", card)
    profile_slice(run_slice, label="slice (vit)", ops=8,
                  ranges=(ATTENTION_RANGE,))
    embed = lambda: ex.extract_scene_device(scene, dcfg, device_scene=ds)
    against_plain(run_slice, embed, out, valid, "vit")
    emb_bf16 = embed()
    # the float path (data.quantize_uint8=False): every slot through K1's
    # gather and the float32 products
    fcfg = dataclasses.replace(dcfg, quantize_uint8=False)
    emb_f, f_launches = counted(lambda: ex.extract_scene_device(
        scene, fcfg, device_scene=ds))
    print(f"vit float path (data.quantize_uint8=False) launches: "
          f"{f_launches}")
    require(emb_f.shape == emb_bf16.shape and bool(torch.isfinite(emb_f)
                                                   .all()),
            f"vit float path embeddings {tuple(emb_f.shape)}")
    require_launches(f_launches, ("window_gather",),
                     [k for k in f_launches if k != "window_gather"],
                     "the vit float path")
    del ex, model, emb_f
    torch.cuda.empty_cache()
    runs = [launches, f_launches]

    runs.append(vit_training(dev, card, mcfg, scene))
    # model.quantize is a no-op for vit: the config warns, the model
    # serves bf16 through no w8a8 kernel
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        qcfg = ModelConfig(variant="vit", input_image_scales=VIT_SCALES,
                           quantize="w8a8")
    require(any("quantize is a no-op" in str(w.message) for w in caught),
            "model.quantize=w8a8 with vit did not warn")
    qmodel = build_model(qcfg)
    qmodel.load_state_dict(init_state_dict(qcfg, seed=0), strict=True)
    qex = FeatureExtractor(qmodel, batch_size=dcfg.eval_batch_size,
                           device=dev)
    emb_q, q_launches = counted(lambda: qex.extract_scene_device(
        scene, dcfg, device_scene=ds))
    require(torch.equal(emb_q, emb_bf16), "vit with model.quantize=w8a8 "
            "must serve the bf16 embeddings")
    require_launches(q_launches, (), [k for k in q_launches if "q8" in k],
                     "vit with model.quantize=w8a8")
    print("vit with model.quantize=w8a8: warned, and served the bf16 "
          "embeddings bit for bit through no w8a8 kernel")
    del qex, qmodel, emb_bf16

    runs.extend(legacy_and_tiles(dev, scene))
    eval_run(repo)
    profiling_helpers(dev)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return runs


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
    # development runs: ``--only patches,kernels,trained,scaleout,family``
    # runs those phases alone (after the card, the build and the scene;
    # patches: K1's fused patch kernel, a part of phase 3; family: phase 10)
    # and prints no result lines
    only = None
    if "--only" in sys.argv[1:]:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        require(only <= {"patches", "kernels", "trained", "scaleout",
                         "family"}, f"unknown phases {only}")

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
    sources = ("patch_resize", "window_gather", "fused_block",
               "fused_block_q8", "fused_attention", "label_lookup",
               "int4_dot")
    t = time.perf_counter()
    build.build_all(sources)
    print(f"build: {', '.join(k + '.cu' for k in sources)} in "
          f"{time.perf_counter() - t:.1f} s -> {build.BUILD_DIR}")
    for k, log in build.build_logs.items():
        for kernel, regs, spill in ptxas_summary(log):
            print(f"  ptxas[{k}] {kernel}: {regs} registers, {spill}")

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
    if only is not None and "patches" in only:
        check_patch_resize(dev, ds, scene)
    if only is None or "kernels" in only:
        kernel_results = check_kernels(dev, ds, scene)
        kernel_results.update(check_patch_resize(dev, ds, scene))
        check_gemms(dev)
        check_gemms_q8(dev)
        kernel_results.update(check_k4(dev))
        k4_ms = kernel_results["fused_block_q8"]["ms"]
        k2_ms = kernel_results["fused_block"]["ms"]
        print(f"K4 block {k4_ms:.3f} ms against K2's {k2_ms:.3f} (B 1024, N "
              f"192; target K4 < K2: {target(k4_ms < k2_ms)})")
        check_k4a_core(dev)
        kernel_results.update(check_k4a(dev))
        kernel_results.update(check_k5(dev))
        kernel_results.update(check_k6(dev))
        kernel_results.update(check_wide_tokens(dev))
        kernel_results.update(check_label_lookup(dev, scene))
        k10, probe_launches = check_int4_dot(dev)
        kernel_results.update(k10)
    if only is not None:
        with tempfile.TemporaryDirectory() as walk_root:
            if only & {"trained", "scaleout"}:
                walk = export_folder(
                    walk_root, SERVE_SCENES if "scaleout" in only else 1)
                _, trained, thr, _ = trained_parity_phase(
                    dev, card, scene, ds, dcfg, edges_d, valid_d, valid,
                    region_map, walk)
            if "scaleout" in only:
                scale_out_phase(dev, card, scene, ds, dcfg, edges_d, valid_d,
                                region_map, trained, thr, walk)
        if "family" in only:
            family_phase(dev, card, repo, scene, edges_d, valid_d, valid,
                         region_map)
        print(f"partial run ({','.join(sorted(only))}) in "
              f"{time.perf_counter() - t_start:.1f} s: no result lines")
        return 0

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

    bf16_kernels = ("patch_resize", "fused_block", "fused_block_chain")
    q8_kernels = ("patch_resize", "fused_block_q8", "fused_block_chain_q8")
    q8a_kernels = ("patch_resize", "fused_block_q8_attn",
                   "fused_block_chain_q8_attn")  # K4a
    # K5 and K6 run in training only; K7, K8 on blocks off the kernels; K1's
    # gather on the float path only
    attention = ("attention_qkv", "attention_bnhd", "fused_block_train",
                 "fused_attention_train")
    # K9 expands every slice's merged map; K10 is a probe, on no path
    tail = ("label_lookup",)
    off_path = attention + ("window_gather", "int4_dot")
    block_kernels = bf16_kernels[1:] + q8_kernels[1:] + q8a_kernels[1:]
    n_chunks = -(-scene.regions.num_points // dcfg.eval_batch_size)
    n_slots = len(dcfg.patch_sizes)

    def require_patch_launches(launches, what, chunks=n_chunks):
        require(launches["patch_resize"] == n_slots * chunks,
                f"patch_resize launched {launches['patch_resize']} times on "
                f"{what}, want {n_slots} a chunk of {chunks}")

    # 4. the bf16 slice
    ex_bf16 = extractor_for("")
    run_bf16 = slice_runner(ex_bf16)
    t = time.perf_counter()
    out, launches = counted(run_bf16)
    print(f"slice (bf16) launches: {launches} (first run "
          f"{time.perf_counter() - t:.3f} s)")
    require_launches(launches, bf16_kernels + tail,
                     q8_kernels[1:] + q8a_kernels[1:] + off_path,
                     "the bf16 slice")
    require_patch_launches(launches, "the bf16 slice")
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
    require_launches(launches, q8_kernels + tail,
                     bf16_kernels[1:] + q8a_kernels[1:] + off_path,
                     "the w8a8 slice")
    require_patch_launches(launches, "the w8a8 slice")
    map_q8, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                              scene.labels.shape)
    print(f"slice (w8a8): {k} clusters after {n_rounds} rounds; label "
          f"disagreement with the bf16 slice {label_disagreement(map_bf16, map_q8):.5f} "
          "(random weights: printed, not gated)")
    time_slice(run_q8, "w8a8", card)
    profile_slice(run_q8)
    # the same slice with the patch stage unfused (K1's gather with its
    # bounds check, and the two float32 products), unfused without the
    # bounds check, then fused again
    with unfused_patch_stage():
        time_slice(run_q8, "w8a8, unfused patch stage", card)
        profile_slice(run_q8, label="slice (w8a8, unfused patch stage)")
    with unfused_patch_stage(bounds_check=False):
        time_slice(run_q8, "w8a8, unfused patch stage, trusted origins",
                   card)
    time_slice(run_q8, "w8a8, fused patch stage again", card)
    against_plain(run_q8, embedder(ex_q8), out, valid, "w8a8")
    all_launches.update({k: launches[k] for k in q8_kernels[1:]})
    path_runs.append(launches)

    # the float path: the slice's embeddings without the uint8 rounding
    # take K1's gather and the float32 products, not patch_resize
    fcfg = dataclasses.replace(dcfg, quantize_uint8=False)
    emb, launches = counted(lambda: ex_q8.extract_scene_device(
        scene, fcfg, device_scene=ds))
    print(f"float path (data.quantize_uint8=False, w8a8) launches: "
          f"{launches}")
    require(emb.shape[0] == scene.regions.num_points
            and bool(torch.isfinite(emb).all()),
            f"float path embeddings {tuple(emb.shape)}")
    require_launches(launches, ("window_gather",), ("patch_resize",),
                     "the float path")
    all_launches["window_gather"] = launches["window_gather"]

    ex_static = extractor_for("w8a8-static")
    require(ex_static.needs_calibration, "w8a8-static starts uncalibrated")
    run_static = slice_runner(ex_static)
    t = time.perf_counter()
    out, launches = counted(run_static)
    print(f"slice (w8a8-static) launches: {launches}, calibrated on the "
          f"first chunk ({time.perf_counter() - t:.3f} s with calibration)")
    require(not ex_static.needs_calibration, "w8a8-static did not calibrate")
    require_launches(launches, q8_kernels + tail,
                     bf16_kernels[1:] + q8a_kernels[1:] + off_path,
                     "the w8a8-static slice")
    # the calibration runs the first chunk once more
    require_patch_launches(launches, "the w8a8-static slice", n_chunks + 1)
    path_runs.append(launches)
    _, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                         scene.labels.shape)
    print(f"slice (w8a8-static): {k} clusters after {n_rounds} rounds")
    time_slice(run_static, "w8a8-static", card)
    against_plain(run_static, embedder(ex_static), out, valid,
                  "w8a8-static")
    del ex_static, run_static
    torch.cuda.empty_cache()

    # 5b. w8a8+attn: the w8a8 blocks and chains with K4a's int8 attention
    ex_q8a = extractor_for("w8a8+attn")
    run_q8a = slice_runner(ex_q8a)
    t = time.perf_counter()
    out, launches = counted(run_q8a)
    print(f"slice (w8a8+attn) launches: {launches} (first run "
          f"{time.perf_counter() - t:.3f} s)")
    require_launches(launches, q8a_kernels + tail,
                     bf16_kernels[1:] + q8_kernels[1:] + off_path,
                     "the w8a8+attn slice")
    require_patch_launches(launches, "the w8a8+attn slice")
    depth = ModelConfig().depth
    want = {"fused_block_q8_attn": depth[0] * n_chunks,
            "fused_block_chain_q8_attn": 2 * n_chunks}
    require(all(launches[k] == v for k, v in want.items()),
            f"K4a launches {launches}, want {want}")
    all_launches.update({k: launches[k] for k in q8a_kernels[1:]})
    path_runs.append(launches)
    _, k, n_rounds = check_slice_outputs(out, r, n_edges, valid,
                                         scene.labels.shape)
    map_q8a = out[3].cpu().numpy()
    print(f"slice (w8a8+attn): {k} clusters after {n_rounds} rounds; label "
          f"disagreement with the w8a8 slice "
          f"{label_disagreement(map_q8, map_q8a):.5f} (random weights: "
          "printed, not gated)")
    time_slice(run_q8a, "w8a8+attn", card)
    profile_slice(run_q8a, label="slice (w8a8+attn)")
    against_plain(run_q8a, embedder(ex_q8a), out, valid, "w8a8+attn")
    del ex_q8a, run_q8a
    torch.cuda.empty_cache()

    # 5c. v5 (the designed-feature token in the sequence: N = 193/49/13)
    # served in w8a8 through K4, then at the reference's erf GELU, whose
    # blocks leave the block kernels: K7 in each, no block kernel
    v5_blocks = sum(ModelConfig().depth)
    for label, quantize, kw, on, off in (
            ("v5 w8a8", "w8a8", dict(variant="v5"), q8_kernels,
             bf16_kernels[1:] + q8a_kernels[1:] + off_path),
            ("v5 exact_gelu", "", dict(variant="v5", exact_gelu=True),
             ("patch_resize", "attention_qkv"),
             block_kernels + off_path[1:])):
        ex = extractor_for(quantize, **kw)
        run = slice_runner(ex)
        t = time.perf_counter()
        out, launches = counted(run)
        print(f"slice ({label}) launches: {launches} (first run "
              f"{time.perf_counter() - t:.3f} s)")
        require_launches(launches, on + tail, off, f"the {label} slice")
        require_patch_launches(launches, f"the {label} slice")
        path_runs.append(launches)
        if "attention_qkv" in on:
            require(launches["attention_qkv"] == v5_blocks * n_chunks,
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

    # the serving scenes, written once for phases 6 and 9
    walk_root = tempfile.mkdtemp(prefix="chip_smoke_walk_")
    try:
        # 6. the serving walk
        t = time.perf_counter()
        walk = export_folder(walk_root, SERVE_SCENES)
        print(f"serving folder: {SERVE_SCENES} scenes of {SERVE_SCENE} "
              f"({sum(c[0] for c in walk[2].values())} points) written in "
              f"{time.perf_counter() - t:.1f} s")
        launches = serving_walk(ex_q8.model, dev, card, walk)
        require_launches(launches, q8_kernels,
                         bf16_kernels[1:] + q8a_kernels[1:] + off_path,
                         "the serving walk")
        path_runs.append(launches)
        del ex_q8, run_q8
        torch.cuda.empty_cache()

        # 7. training: the flagship, v5 with its aux losses, then the
        # flagship through the training block K5
        launches, (v3_ms, v3_losses) = training_phase(
            dev, card, ModelConfig(), "v3")
        all_launches["fused_attention_train"] = \
            launches["fused_attention_train"]
        path_runs.append(launches)
        path_runs.append(training_phase(dev, card, ModelConfig(variant="v5"),
                                        "v5", aux_weights=(0.1, 0.2))[0])
        launches, (k5_ms, k5_losses) = training_phase(
            dev, card, ModelConfig(), "v3 train.fused_block", fused_block=True)
        all_launches["fused_block_train"] = launches["fused_block_train"]
        path_runs.append(launches)
        rel0 = abs(k5_losses[0] - v3_losses[0]) / abs(v3_losses[0])
        pairs_s = lambda ms: TRAIN_PAIRS / ms * 1e3
        print(f"training step, v3 through K5 against the unfused v3 (this "
              f"run, {card}): median {k5_ms:.1f} vs {v3_ms:.1f} ms "
              f"({pairs_s(k5_ms):.1f} vs {pairs_s(v3_ms):.1f} pairs/s); "
              f"step-0 loss {k5_losses[0]} vs {v3_losses[0]}, rel diff "
              f"{rel0:.3e} (max {TOL_K5_VS_UNFUSED_LOSS0})")
        require(rel0 <= TOL_K5_VS_UNFUSED_LOSS0,
                f"step-0 loss through K5 differs from the unfused one: "
                f"{rel0}")
        # 8. the parity bar on trained weights
        _, trained, thr, launches = trained_parity_phase(
            dev, card, scene, ds, dcfg, edges_d, valid_d, valid, region_map,
            walk)
        path_runs.append(launches)
        # 9. scale-out: the sharded paths at world size 1 on NCCL, then two
        # ranks on the one card over gloo
        path_runs.extend(scale_out_phase(dev, card, scene, ds, dcfg, edges_d,
                                         valid_d, region_map, trained, thr,
                                         walk))
    finally:
        shutil.rmtree(walk_root, ignore_errors=True)
    # 10. the modules of PR 10's slice: vit, legacy, tiles, eval, profiling
    family_runs = family_phase(dev, card, repo, scene, edges_d, valid_d,
                               valid, region_map)
    path_runs.extend(family_runs)
    # K1's counts in the kernels line add phase 10's vit slice (fused
    # patch kernel and gather) to the bf16 slice's and the float path's
    for k in ("patch_resize", "window_gather"):
        all_launches[k] += family_runs[0][k]
    # no model path runs K8: each run above required its count to be 0
    all_launches["attention_bnhd"] = sum(l["attention_bnhd"]
                                         for l in path_runs)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    sources = {
        "patch_resize": ("deepmerge_tpu_torch/csrc/patch_resize.cu",
                         "deepmerge_tpu/ops/pallas/window_gather.py:37"),
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
        "fused_block_q8_attn": (
            "deepmerge_tpu_torch/csrc/fused_block_q8.cu",
            "deepmerge_tpu/ops/pallas/fused_block.py:69"),
        "fused_block_chain_q8_attn": (
            "deepmerge_tpu_torch/csrc/fused_block_q8.cu",
            "deepmerge_tpu/ops/pallas/fused_block.py:415"),
        "fused_block_train": ("deepmerge_tpu_torch/csrc/fused_block.cu",
                              "deepmerge_tpu/ops/pallas/fused_block.py:558"),
        "fused_attention_train": (
            "deepmerge_tpu_torch/csrc/fused_attention.cu",
            "deepmerge_tpu/ops/pallas/fused_attention.py:311"),
        "attention_qkv": ("deepmerge_tpu_torch/csrc/fused_attention.cu",
                          "deepmerge_tpu/ops/pallas/fused_attention.py:143"),
        "attention_bnhd": ("deepmerge_tpu_torch/csrc/fused_attention.cu",
                           "deepmerge_tpu/ops/pallas/fused_attention.py:26"),
        "label_lookup": ("deepmerge_tpu_torch/csrc/label_lookup.cu",
                         "tools/gather_probe.py:45"),
        "int4_dot": ("deepmerge_tpu_torch/csrc/int4_dot.cu",
                     "tools/int4_dot_probe.py:41"),
    }
    # K10 runs on no path of either package: its count is the probe's own
    all_launches["int4_dot"] = probe_launches
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
