"""Rounding ties of the exact patch path, for the port's CPU tests.

The exact path rounds x2 / s² to a uint8 code, where x2 is a float32 sum of
float32 column weights (most of them not integers) times exact integers.
Where x2 / s² lies on a rounding tie, or within the sum's rounding error of
one, the order of that sum decides the code. The JAX package's CPU path
sums in an order that XLA picks per shape; the port's plain version sums in
PyTorch's. So the two are held equal code for code wherever the value lies
more than ``TIE`` from a tie, and at most one code apart within it.
``unrounded`` gives the value each code rounds, in float64 from the same
float32 weights (products and sums exact or nearly so), so the tests can
tell the ties apart.

Run as ``python -m tests.patch_ties`` to print, for each of the vit sides,
which of a few fixed summation orders reproduce the JAX package's x2 bit
for bit, and how many codes each gives that differ from the JAX package's.
"""

import numpy as np
import torch

from deepmerge_tpu_torch.ops.kernels import patch_resize as pr
from deepmerge_tpu_torch.ops.kernels.window_gather import (
    ROW_ALIGN,
    gather_windows_ref,
    pixel_align,
)
from deepmerge_tpu_torch.ops.resize import resize_weights

# The largest distance from a tie at which a code differed (1.8e-5 of a
# code, on 200 random points a side at out 28/56/112/224), with room.
TIE = 5e-5


def _operands(padded, centers, scales, cap, out, pad):
    """The column weights (B, p, j) and the row pass (B, o, j, C) of one
    slot, both float64, as the exact path (cap <= 256) or the float path
    forms them; and the window sides s (1 on the float path)."""
    padded = torch.as_tensor(padded)
    c = padded.shape[-1]
    starts, s, off_y, off_x = pr.slot_geometry(
        torch.as_tensor(centers, dtype=torch.int32),
        torch.as_tensor(scales, dtype=torch.int32), cap, pad, c)
    rows, px = cap + ROW_ALIGN, cap + pixel_align(c)
    win = gather_windows_ref(padded.reshape(padded.shape[0], -1), starts,
                             rows, px * c).double()
    wr = resize_weights(out, rows, s, off_y)
    wc = resize_weights(out, px, s, off_x)
    if cap <= pr.MAX_CAP:
        s32 = s.to(torch.float32)[:, None, None]
        wr = (wr * s32).to(torch.bfloat16)
        wc = wc * s32
    else:
        s = torch.ones_like(s)
    x1 = torch.bmm(wr.double(), win).reshape(len(s), out, px, c)
    return wc.double(), x1, s


def unrounded(padded, centers, scales, cap, out, pad, channels=None):
    """(B, out, out, channels) float64: the pixel value (0..255) that each
    uint8 code of a slot's patches rounds."""
    wc, x1, s = _operands(padded, centers, scales, cap, out, pad)
    x2 = torch.einsum("bpj,bojc->bopc", wc, x1)
    v = x2 / s.double()[:, None, None, None] ** 2
    return v[..., :channels].numpy()


def codes_match(got, want, values):
    """Patches in [0, 1] equal as uint8 codes, and equal to ``values``
    (their ``unrounded`` values) rounded, wherever those lie more than
    ``TIE`` from a rounding tie; within it, at most one code apart."""
    codes = lambda a: np.rint(np.asarray(a, np.float32) * 255).astype(int)
    got, want = codes(got), codes(want)
    tie = np.abs(values - np.floor(values) - 0.5) <= TIE
    off = int((got != np.floor(values + 0.5))[~tie].sum())
    assert off == 0, f"{off} codes away from a tie are not their value's"
    diff = np.abs(got - want)
    assert diff.max(initial=0) <= 1, f"codes {diff.max()} apart"
    off = int((diff[~tie] > 0).sum())
    assert off == 0, f"{off} codes differ away from a rounding tie"


def _sums(wc, x1):
    """x2 in float32 by a few fixed orders over the source index j; an
    FMA step is a float64 add of the exact product, rounded once."""
    prod = (wc[:, None, :, :, None] * x1[:, :, None, :, :]).numpy()
    f32 = lambda a: a.astype(np.float32)
    out = {}
    for name, js in (("ascending", range(prod.shape[3])),
                     ("descending", reversed(range(prod.shape[3])))):
        plain = fma = np.zeros(prod.shape[:3] + prod.shape[4:], np.float32)
        for j in js:
            plain = f32(plain + f32(prod[:, :, :, j]))
            fma = f32(fma.astype(np.float64) + prod[:, :, :, j])
        out[name] = plain
        out[name + ", FMA"] = fma
    for lanes in (2, 4):
        acc = [np.zeros(prod.shape[:3] + prod.shape[4:], np.float32)
               for _ in range(lanes)]
        for j in range(prod.shape[3]):
            acc[j % lanes] = f32(acc[j % lanes].astype(np.float64)
                                 + prod[:, :, :, j])
        while len(acc) > 1:
            h = len(acc) // 2
            acc = [f32(acc[i] + acc[i + h]) for i in range(h)]
        out[f"{lanes} interleaved FMA sums"] = acc[0]
    out["float64, rounded once"] = f32(torch.einsum(
        "bpj,bojc->bopc", wc, x1).numpy())
    out["torch (CPU)"] = torch.einsum("bpj,bojc->bopc", wc.float(),
                                      x1.float()).numpy()
    return out


def main(n=200, seed=0):
    import jax
    import jax.numpy as jnp

    from deepmerge_tpu.ops import patches as jp
    from deepmerge_tpu_torch.ops import patches as tp

    rs = np.random.RandomState(seed)
    h = w = 300
    image = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    pts = np.stack([rs.randint(0, h, n), rs.randint(0, w, n)], 1)
    inner = rs.randint(1, 120, n).astype(np.int32)
    obj = (inner + rs.randint(0, 140, n)).astype(np.int32)
    sizes, cap = (28, 56, 112, 224), 256
    padded = jp.pad_scene(image, cap)
    pad = tp.scene_pad(cap, padded.shape[-1])
    scales = np.asarray(tp.adaptive_scales(inner, obj, sizes)[0])
    xla = jax.jit(lambda a, b: jnp.einsum(
        "bpj,bojc->bopc", a, b, precision=jax.lax.Precision.HIGH,
        preferred_element_type=jnp.float32))
    step = 4  # points a pass: bounds the (step, o, p, j, C) products
    print(f"{n} points, cap {cap}, seed {seed}; per order: x2 values that "
          "differ from XLA's einsum, codes that differ from the JAX "
          "package's patches")
    for slot, out in enumerate(sizes):
        sl = scales[:, slot : slot + 1]
        (want,) = jp.extract_multiscale_patches(
            padded, pts.astype(np.int32), sl, (out,), caps=(cap,),
            out_channels=3, out_dtype=jnp.float32)
        want = np.rint(np.asarray(want) * 255).astype(int)
        s2 = (np.clip(sl[:, 0], 1, cap).astype(np.float32) ** 2)[
            :, None, None, None]
        row = []
        for i in range(0, n, step):
            wc, x1, _ = _operands(padded, pts[i : i + step],
                                  sl[i : i + step, 0], cap, out, pad)
            sums = _sums(wc, x1)
            ref = np.asarray(xla(wc.float().numpy(), x1.float().numpy()))
            for j, (name, x2) in enumerate(sums.items()):
                k = np.floor(x2 / s2[i : i + step] + np.float32(0.5))
                d2 = 2 * (x2 - k * s2[i : i + step])
                k = k + (d2 >= s2[i : i + step]) - (d2 < -s2[i : i + step])
                bad = int((k[..., :3] != want[i : i + step]).sum())
                miss = int((x2 != ref).sum())
                if i == 0:
                    row.append([name, miss, bad])
                else:
                    row[j][1] += miss
                    row[j][2] += bad
        print(f"out {out} ({want.size} codes): " + "; ".join(
            f"{name} {miss}/{bad}" for name, miss, bad in row))
        got = pr.patch_resize_ref(
            torch.from_numpy(padded), torch.from_numpy(pts.astype(np.int32)),
            torch.as_tensor(sl[:, 0]), cap, out, pad, 3, chunk=50)
        got = np.rint(got.numpy() * 255).astype(int)
        values = np.concatenate([
            unrounded(padded, pts[i : i + 50], sl[i : i + 50, 0], cap, out,
                      pad, 3) for i in range(0, n, 50)])
        far = np.abs(values - np.floor(values) - 0.5)[got != want]
        print(f"  the port's plain version: {far.size} codes differ, the "
              f"farthest {far.max(initial=0):.3g} from a tie")


if __name__ == "__main__":
    main()
