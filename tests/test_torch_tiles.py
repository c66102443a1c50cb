"""Class-patch tiles, the host resize ops and pairwise distances of the
PyTorch port (``geodata/tiles.py``, ``ops/resize.crop_resize`` /
``area_resize``, ``ops/segment.pairwise_sqdist``) and the exact patch path
at the vit sides, against the JAX package's, on the CPU.

Tolerances. ``crop_resize`` and ``area_resize`` with the uint8 rounding
bit-exact; without it within 1e-5 of max|JAX|: each pass sums up to ~70
float32 products in another order than XLA's (bound n·2^-24 ≈ 4e-6 a pass;
measured 2.6e-6). Distances within 1e-5 relative. Patches: equal code for
code wherever the value a code rounds lies more than ``patch_ties.TIE``
(5e-5) from a rounding tie, at most one code apart within it
(``tests/patch_ties.py``). The exact path's column weights scaled by the
window side are float32 values, most of them not integers, so the order of
the float32 column sum decides a value that lands on a tie. At out 32, 64
and 128 no such value shows on the inputs of ``test_torch_patch_resize.py``
(bit-exact there); at the vit sides some do, and the JAX package's CPU
path sums in an order that XLA picks per shape (``python -m
tests.patch_ties`` prints which fixed orders reproduce it at each side).
On its 200 random points at cap 256 the port and the JAX package differ
in 14 of 470,400 codes at out 28, 0 at 56, 61 of 7.5M at 112 and 942 of
30.1M at 224, every one within 1.9e-5 of a tie.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.geodata import tiles as jtiles
from deepmerge_tpu.ops import patches as jp
from deepmerge_tpu.ops import resize as jr
from deepmerge_tpu.ops import segment as jseg
from deepmerge_tpu_torch import ops as tops
from deepmerge_tpu_torch.geodata import tiles as ttiles
from deepmerge_tpu_torch.ops import patches as tp
from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
from tests.patch_ties import codes_match, unrounded
from tests.torch_threads import one_torch_thread  # noqa: F401


def _image(seed, h=97, w=131, c=3):
    return (np.random.RandomState(seed).rand(h, w, c) * 255).astype(np.uint8)


def _points(seed, n, h=97, w=131):
    rs = np.random.RandomState(seed)
    pts = np.stack([rs.randint(0, h, n), rs.randint(0, w, n)], 1)
    pts[:4] = [[0, 0], [h - 1, w - 1], [0, w - 1], [h - 1, 0]]
    return pts.astype(np.int32)


def test_ops_export_the_jax_names():
    import deepmerge_tpu.ops as jops

    names = [n for n in dir(jops) if not n.startswith("_")
             and callable(getattr(jops, n))]
    assert [n for n in names if not hasattr(tops, n)] == []


def test_split_indices_equal():
    for n, frac, seed in ((100, 0.8, 42), (7, 0.5, 3), (1, 0.8, 0)):
        for a, b in zip(ttiles.split_indices(n, frac, seed),
                        jtiles.split_indices(n, frac, seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window,out", [(224, 224), (40, 16), (300, 32)])
def test_cut_class_patches_equal_jax(window, out):
    """Window 224 (cap 256: the fused path's plain version), a small
    window, and one above 256 (the float path)."""
    image, pts = _image(1), _points(2, 6)
    got = ttiles.cut_class_patches(image, pts, window, out, device="cpu")
    want = jtiles.cut_class_patches(image, pts, window, out)
    assert got.shape == (6, out, out, 3) and got.dtype == np.float32
    padded, caps = ttiles.stage_tiles(image, window, device="cpu")
    values = unrounded(padded, pts, np.full(6, window), caps[0], out,
                       tp.scene_pad(caps, padded.shape[-1]), 3)
    codes_match(got, want, values)


def test_export_and_load_round_trip(tmp_path):
    """The port's shards hold what ``cut_class_patches`` cuts, split as the
    JAX package splits, and read back through both packages' loaders."""
    image, pts = _image(3), _points(4, 10)
    ids = np.arange(10) % 3
    kw = dict(window=32, out_size=16, train_frac=0.7, shard_size=4)
    written = ttiles.export_class_patches(str(tmp_path / "t"), image, pts,
                                          ids, device="cpu", **kw)
    jwritten = jtiles.export_class_patches(str(tmp_path / "j"), image, pts,
                                           ids, **kw)
    assert [list(map(os.path.basename, written[s])) for s in written] == \
        [list(map(os.path.basename, jwritten[s])) for s in jwritten]
    tr, va = ttiles.split_indices(10, 0.7, 42)
    whole = ttiles.cut_class_patches(image, pts, 32, 16, device="cpu")
    for split, idx in (("train", tr), ("val", va)):
        got_p, got_l = zip(*map(ttiles.load_patch_shard, written[split]))
        want_p, want_l = zip(*map(jtiles.load_patch_shard, jwritten[split]))
        np.testing.assert_array_equal(np.concatenate(got_p), whole[idx])
        np.testing.assert_array_equal(np.concatenate(got_p),
                                      np.concatenate(want_p))
        np.testing.assert_array_equal(np.concatenate(got_l), ids[idx])
        np.testing.assert_array_equal(np.concatenate(got_l),
                                      np.concatenate(want_l))
        with np.load(written[split][0]) as z:
            np.testing.assert_array_equal(z["index"], idx[:4])


def test_tiles_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttiles.cut_class_patches(_image(0), _points(0, 4), 32, 16)


@pytest.mark.parametrize("quantize", [True, False])
def test_crop_resize_against_jax(quantize):
    """Shrinks and enlargements, offsets that differ per axis."""
    rs = np.random.RandomState(5)
    window = rs.randint(0, 256, (64, 64, 3)).astype(np.float32)
    for scale, oy, ox, out in ((37, 3, 5, 16), (9, 0, 2, 28), (64, 0, 0, 56),
                               (20, 11, 1, 20)):
        want = np.asarray(jr.crop_resize(jnp.asarray(window), scale, oy, ox,
                                         out, quantize))
        got = tops.crop_resize(torch.from_numpy(window), scale, oy, ox, out,
                               quantize).numpy()
        assert got.shape == (out, out, 3)
        if quantize:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("quantize", [True, False])
def test_area_resize_against_jax(quantize):
    image = np.random.RandomState(6).randint(0, 256, (45, 70, 3)).astype(
        np.uint8)
    for out in (8, 28, 64, 100):
        want = np.asarray(jr.area_resize(jnp.asarray(image), out, quantize))
        got = tops.area_resize(torch.from_numpy(image), out,
                               quantize).numpy()
        if quantize:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pairwise_sqdist_against_jax():
    rs = np.random.RandomState(7)
    x = rs.standard_normal((9, 16)).astype(np.float32)
    y = np.concatenate([x[:3], rs.standard_normal((5, 16)).astype(np.float32)])
    want = np.asarray(jseg.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
    got = tops.pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (9, 8) and bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("caps", [(128, 128, 128, 256), (256,) * 4])
def test_exact_path_at_vit_sides_equal_jax(caps):
    """The fused patch kernel's plain version at out 28/56/112/224 (tiles
    of 16 or 8 rows, partial last tiles at 28 and 56) against the JAX
    package's exact path, float32 patches (a code apart is visible there)
    and bf16 ones as the vit slice serves them."""
    rs = np.random.RandomState(8)
    image = _image(8)
    n, sizes = 12, (28, 56, 112, 224)
    pts = _points(9, n)
    inner = rs.randint(1, 60, n).astype(np.int32)
    obj = (inner + rs.randint(0, 50, n)).astype(np.int32)
    padded = jp.pad_scene(image, caps)
    scales = tp.adaptive_scales(inner, obj, sizes)[0]
    pad = tp.scene_pad(caps, 3)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jp.extract_multiscale_patches(
            padded, pts, jp.adaptive_scales(inner, obj, sizes)[0], sizes,
            caps=caps, out_channels=3, out_dtype=jdt)
        for slot, (cap, out) in enumerate(zip(caps, sizes)):
            got = pr.patch_resize_ref(
                torch.from_numpy(padded), torch.from_numpy(pts),
                scales[:, slot], cap, out, pad, 3, tdt, chunk=5)
            assert got.shape == (n, out, out, 3)
            codes_match(got.float().numpy(),
                        np.asarray(want[slot], np.float32),
                        unrounded(padded, pts, scales[:, slot], cap, out,
                                  pad, 3))
