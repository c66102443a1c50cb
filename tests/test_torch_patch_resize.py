"""The fused patch stage of the PyTorch port (``ops/kernels/patch_resize``),
on the CPU: its plain version against the JAX package's patches, its tap
table against ``resize_weights``, the float32 column weights it must keep,
its launch plan against an H100's limits, the wrapper's checks, and the
serving slice's patch stage without a host sync.

All comparisons are bit-exact: the exact patch path is integer-exact up to
the float32 column weights, which both sides take from the same
``resize_weights``.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from deepmerge_tpu.ops import patches as jp
from deepmerge_tpu_torch.ops import patches as tp
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
from deepmerge_tpu_torch.ops.kernels import window_gather as wg
from deepmerge_tpu_torch.ops.resize import resize_weights


def _scene(seed, h, w, c):
    return (np.random.RandomState(seed).rand(h, w, c) * 255).astype(np.uint8)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bands", [1, 3, 4, 5])
def test_ref_bit_identical_to_jax(bands, out_dtype):
    """Caps (128, 128, 256), sizes (32, 64, 128), points on every edge and
    corner and inside, window sides from 1 to above the caps."""
    import jax.numpy as jnp

    rs = np.random.RandomState(bands)
    h, w = 97, 131
    image = _scene(bands, h, w, bands)
    n = 14
    pts = np.stack([rs.randint(0, h, n), rs.randint(0, w, n)], 1)
    pts[:6] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0], [0, 60],
               [50, w - 1]]
    pts = pts.astype(np.int32)
    inner = rs.randint(1, 60, n).astype(np.int32)
    obj = (inner + rs.randint(0, 60, n)).astype(np.int32)
    sizes, caps = (32, 64, 128), (128, 128, 256)
    targets = sizes + (1,)
    padded = jp.pad_scene(image, caps)
    want = jp.extract_multiscale_patches(
        padded, pts, jp.adaptive_scales(inner, obj, targets)[0], sizes,
        caps=caps, out_channels=bands, out_dtype=getattr(jnp, out_dtype))
    scales = tp.adaptive_scales(inner, obj, targets)[0]
    pad = tp.scene_pad(caps, bands)
    for slot, (cap, out) in enumerate(zip(caps, sizes)):
        got = pr.patch_resize_ref(
            torch.from_numpy(padded), torch.from_numpy(pts), scales[:, slot],
            cap, out, pad, bands, getattr(torch, out_dtype), chunk=5)
        assert got.dtype == getattr(torch, out_dtype)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want[slot], np.float32),
            err_msg=f"slot {slot}")


def _dense(taps: pr.Taps, weights: torch.Tensor, s_lo: int, s_hi: int,
           off: int, extent: int) -> torch.Tensor:
    """(s_hi - s_lo, out, extent) weights of window sides s_lo..s_hi - 1
    at ``off``, rebuilt from the table."""
    first = taps.first[s_lo - 1 : s_hi - 1].long()
    w = weights[s_lo - 1 : s_hi - 1]
    idx = off + first[..., None] + torch.arange(taps.taps)
    keep = (w != 0) & (idx < extent)
    # every nonzero weight lies inside the extent
    assert bool(((w != 0) <= keep).all())
    dense = torch.zeros(w.shape[:2] + (extent,), dtype=torch.float32)
    return dense.scatter_add_(-1, torch.where(keep, idx, 0),
                              torch.where(keep, w, 0.0))


@pytest.mark.parametrize("cap", [128, 256])
@pytest.mark.parametrize("out", [16, 32, 64, 128])
def test_tap_table_equals_resize_weights(out, cap):
    taps = pr.resize_taps(out, cap)
    assert taps.first.shape == (cap, out) and taps.first.dtype == torch.int32
    assert taps.rows.shape == taps.cols.shape == (cap, out, taps.taps)
    # the row weights are bf16-rounded integers; no output index needs more
    # than `taps` taps, and the last tap of some index is nonzero
    assert bool((taps.rows == taps.rows.round()).all())
    assert bool((taps.cols[..., -1] != 0).any())
    assert taps.taps <= -(-cap // out) + 1
    for off, extent in ((0, cap + 32), (1, cap + 32), (7, cap + 128),
                        (31, cap + 32), (16, cap + 16)):
        for s_lo in range(1, cap + 1, 64):
            s_hi = min(s_lo + 64, cap + 1)
            s = torch.arange(s_lo, s_hi, dtype=torch.int32)
            want = resize_weights(out, extent, s, torch.full_like(s, off)) \
                * s.to(torch.float32)[:, None, None]
            cols = _dense(taps, taps.cols, s_lo, s_hi, off, extent)
            rows = _dense(taps, taps.rows, s_lo, s_hi, off, extent)
            assert torch.equal(cols, want), (off, s_lo)
            assert torch.equal(rows, want.to(torch.bfloat16).float()), \
                (off, s_lo)


def test_float32_column_weights_are_needed():
    """At out 128 the column weights scaled by s are not integers for 120
    of the 128 window sides. Rounding them to integers changes pixels of
    random windows; the table's float32 weights, summed tap by tap in
    another order than the plain version's product, do not."""
    cap, out, b = 128, 128, 32
    taps = pr.resize_taps(out, cap)
    assert int((taps.cols != taps.cols.round()).any(-1).any(-1).sum()) == 120
    rs = np.random.RandomState(0)
    win = torch.from_numpy(
        rs.randint(0, 256, (b, cap + 32, cap + 128)).astype(np.uint8))
    s = torch.from_numpy(rs.randint(1, cap + 1, b).astype(np.int32))
    zero = torch.zeros(b, dtype=torch.int32)
    want = pr.resize_windows_exact(win, s, zero, zero, out, 1)

    def patches(cols):
        first = taps.first[s.long() - 1].long()              # (b, out)
        rows = taps.rows[s.long() - 1]                       # (b, out, T)
        idx = first[..., None] + torch.arange(taps.taps)     # (b, out, T)
        x = win.float()
        x1 = torch.zeros(b, out, x.shape[-1])
        for t in range(taps.taps):
            sel = idx[..., t].clamp(max=x.shape[1] - 1)
            x1 = x1 + rows[..., t, None] * torch.gather(
                x, 1, sel[..., None].expand(-1, -1, x.shape[-1]))
        x2 = torch.zeros(b, out, out)
        for t in reversed(range(taps.taps)):   # the other order
            sel = idx[..., t].clamp(max=x.shape[-1] - 1)
            x2 = x2 + cols[s.long() - 1][:, None, :, t] * torch.gather(
                x1, 2, sel[:, None, :].expand(-1, out, -1))
        s2 = s.float()[:, None, None] ** 2
        k = torch.floor(x2 / s2 + 0.5)
        d2 = 2.0 * (x2 - k * s2)
        k = k + (d2 >= s2).float() - (d2 < -s2).float()
        return (k * pr.INV_255)[..., None]

    assert torch.equal(patches(taps.cols), want)
    assert int((patches(taps.cols.round()) != want).sum()) > 0


@pytest.mark.parametrize("channels", pr.CHANNELS)
@pytest.mark.parametrize("out", [16, 32, 64, 128])
def test_plan_fits_the_card(out, channels):
    for cap in range(2, pr.MAX_CAP + 1, 2):
        plan = pr.patch_resize_plan(cap, out, channels)
        tile, threads, smem = plan["ints"]
        assert threads == pr.THREADS <= 1024   # a CTA's thread limit
        assert 1 <= tile <= min(16, out) and tile * plan["tiles"] >= out
        assert plan["stride"] % 4 == 0
        assert plan["stride"] >= cap * channels + 32
        assert smem == tile * plan["stride"] * 4
        assert smem <= pr.CTA_SHARED <= fb.CTA_SHARED_MAX
    # the slice's slots take tiles of 16 rows
    assert pr.patch_resize_plan(128, out, 4)["tile_rows"] == 16


@pytest.mark.parametrize("cap,out,channels,match", [
    (129, 32, 4, "even caps"), (258, 32, 4, "even caps"),
    (128, 0, 4, "patch sides"), (128, 32, 3, "staged channels"),
])
def test_plan_refuses(cap, out, channels, match):
    with pytest.raises(ValueError, match=match):
        pr.patch_resize_plan(cap, out, channels)


def _staged(seed=2, h=40, w=56, bands=3, caps=(128,)):
    image = torch.from_numpy(_scene(seed, h, w, bands))
    pad = tp.scene_pad(caps, bands)
    return tp.pad_scene_device(image, pad, tp.staged_channels(bands)), pad


def test_wrapper_on_cpu_is_the_plain_version():
    padded, pad = _staged()
    centers = torch.tensor([[0, 0], [39, 55], [20, 30]], dtype=torch.int32)
    scales = torch.tensor([[5, 40], [128, 200], [1, 77]],
                          dtype=torch.int32)[:, 1]   # a strided column
    before = pr.patch_resize.launches
    got = pr.patch_resize(padded, centers, scales, 128, 32, pad,
                          out_channels=3, out_dtype=torch.bfloat16)
    want = pr.patch_resize_ref(padded, centers, scales, 128, 32, pad, 3,
                               torch.bfloat16)
    assert torch.equal(got, want) and got.shape == (3, 32, 32, 3)
    # the plain version runs on the CPU: no kernel launch is counted
    assert pr.patch_resize.launches == before


@pytest.mark.parametrize("change,error,match", [
    (dict(centers=torch.tensor([[-200, 0]], dtype=torch.int32)), ValueError,
     "out of bounds"),
    (dict(centers=torch.tensor([[0, 0]], dtype=torch.int64)), TypeError,
     "centers"),
    (dict(scales=torch.tensor([9.0])), TypeError, "scales"),
    (dict(out_dtype=torch.float16), TypeError, "out_dtype"),
    (dict(out_channels=5), ValueError, "out_channels"),
    (dict(cap=512), ValueError, "even caps"),
])
def test_wrapper_refuses(change, error, match):
    padded, pad = _staged()
    args = dict(centers=torch.tensor([[3, 4]], dtype=torch.int32),
                scales=torch.tensor([9], dtype=torch.int32), cap=128,
                out=16, pad=pad, out_channels=3, out_dtype=torch.float32)
    args.update(change)
    with pytest.raises(error, match=match):
        pr.patch_resize(padded, **args)


def test_exact_slots_route_to_patch_resize_and_float_slots_to_the_gather():
    """Uint8 rounding at caps up to 256: one ``patch_resize`` call per slot
    for all points; a cap above 256, or no rounding, keeps K1's gather."""
    padded, pad = _staged(h=300, w=300, caps=(128, 512))
    rs = np.random.RandomState(5)
    centers = torch.from_numpy(rs.randint(0, 300, (20, 2)).astype(np.int32))
    scales = torch.from_numpy(rs.randint(4, 400, (20, 4)).astype(np.int32))
    calls = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    with mock.patch.object(tp, "patch_resize", spy(pr.patch_resize, "pr")), \
            mock.patch.object(tp, "gather_windows",
                              spy(wg.gather_windows, "gather")):
        tp.extract_multiscale_patches(padded, centers, scales, (16, 32),
                                      caps=(128, 512), chunk=8)
        assert calls == ["pr"] + ["gather"] * 3
        calls.clear()
        tp.extract_multiscale_patches(padded, centers, scales, (16, 32),
                                      caps=(128, 512), chunk=8,
                                      quantize_uint8=False)
        assert calls == ["gather"] * 6


def test_points_inside():
    assert tp.points_inside(np.array([[0, 0], [9, 4]]), 10, 5)
    assert not tp.points_inside(np.array([[0, 0], [10, 4]]), 10, 5)
    assert not tp.points_inside(np.array([[0, -1]]), 10, 5)
    assert tp.points_inside(np.zeros((0, 2), np.int32), 10, 5)


def test_serving_patch_stage_has_no_host_sync():
    """``segment_scene_device`` checks its points once on the host and runs
    every patch stage with trusted origins: the device-side bounds check
    (``window_gather._check``, one sync) never sees an origin, and the
    exact slots take one ``patch_resize`` call each per chunk."""
    from deepmerge_tpu_torch.compat.weights import init_state_dict
    from deepmerge_tpu_torch.config import DataConfig, ModelConfig
    from deepmerge_tpu_torch.geodata.synthetic import generate_scene
    from deepmerge_tpu_torch.infer.extract import FeatureExtractor
    from deepmerge_tpu_torch.models.s2former import S2Former

    mcfg = ModelConfig(input_image_scales=(16, 32, 64), embed_dim=32,
                       depth=(1, 1, 1), num_heads=2, out_dim=8,
                       dtype="float32")
    dcfg = DataConfig(patch_sizes=(16, 32, 64), max_window=128)
    model = S2Former(mcfg)
    model.load_state_dict(init_state_dict(mcfg, seed=0), strict=True)
    ex = FeatureExtractor(model, batch_size=16, device="cpu")
    scene = generate_scene(h=96, w=96, n_regions=12, n_objects=3,
                           points_per_region=2, seed=1)
    edges = torch.from_numpy(scene.rag.edges.astype(np.int32))
    valid = torch.ones(edges.shape[0], dtype=torch.bool)
    seen, calls = [], []
    check, resize = wg._check, tp.patch_resize

    def spy_check(scene2d, starts, rows, cols):
        seen.append(starts.shape[0])
        return check(scene2d, starts, rows, cols)

    def spy_resize(*args, **kwargs):
        calls.append(kwargs["trusted_origins"])
        return resize(*args, **kwargs)

    with mock.patch.object(wg, "_check", spy_check), \
            mock.patch.object(tp, "patch_resize", spy_resize):
        out = ex.segment_scene_device(scene, dcfg, edges, valid,
                                      num_regions=scene.regions.num_regions)
    assert np.isfinite(out[0].numpy()).all()
    n_chunks = -(-scene.regions.num_points // 16)
    assert calls == [True] * (3 * n_chunks)
    assert all(n == 0 for n in seen)
