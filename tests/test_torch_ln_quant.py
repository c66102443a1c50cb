"""The w8a8 blocks' LayerNorm + quantize (``ln_quant_ref``, the plain
version of csrc/fused_block_q8.cu ``ln_quant_kernel``) against the JAX
package, on the CPU, at row widths of the kernel's wider forms: 1536 (one
warp, 6 vectors a lane), 3072 (two warps) and 8192 (four warps).

The JAX side is the TPU kernel's own math: ``_ln`` (two-pass float32
statistics), then the row quantize of ``_qdot`` (dynamic: s = max|y|/127
per row, codes clip(round(y / s), ±127)) or ``_qdot_static`` (codes
clip(round(y · (1/s)), ±127) at a calibrated s), taken through those
functions themselves: their int8 dot against the identity returns the
codes times the row scale, from which the codes come back exactly
(|code| <= 127). The same seeded numpy rows in bf16 go to both sides.

Tolerances: the codes bit-exact, or one step apart on at most a thousandth
of them: both sides sum a row in float32 in their own order, so an output
one ulp apart can cross a rounding boundary; the row scales within 1e-6
relative (the abs-max of the same outputs, divided by 127 in each
library's way: an ulp or so).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops.pallas import fused_block as jfb
from deepmerge_tpu_torch.ops.kernels import fused_block as fb
from tests.torch_threads import one_torch_thread  # noqa: F401

CODE_FLIPS_MAX = 1e-3
SCALE_TOL = 1e-6
ROWS = 6


def _jax_codes(y, static):
    """codes (ROWS, C) int and row scales (ROWS,) of the JAX package's row
    quantize of the float32 ``y``, through ``_qdot`` / ``_qdot_static``
    with the identity as the int8 weight and unit column scales."""
    c = y.shape[1]
    eye = jnp.eye(c, dtype=jnp.int8)
    ones = jnp.ones((c,), jnp.float32)
    if static is None:
        amax = jnp.max(jnp.abs(y), axis=-1)
        sr = np.asarray(jnp.where(amax > 0, amax / 127.0, 1.0))
        out = np.asarray(jfb._qdot(y, eye, ones))
    else:
        sr = np.full((y.shape[0],), static, np.float32)
        out = np.asarray(jfb._qdot_static(y, eye, ones, jnp.float32(static)))
    return np.rint(out / sr[:, None]).astype(np.int32), sr


@pytest.mark.parametrize("static", [None, 0.031], ids=["dynamic", "static"])
@pytest.mark.parametrize("c", [1536, 3072, 8192])
def test_ln_quant_ref_matches_jax(c, static):
    rs = np.random.default_rng(c + (static is not None))
    x = rs.standard_normal((ROWS, c)).astype(np.float32)
    x[0] *= 0.0  # a zero row: dynamic scale 1, codes of the bias alone
    w = (1.0 + 0.1 * rs.standard_normal(c)).astype(np.float32)
    b = (0.1 * rs.standard_normal(c)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    st = None if static is None else torch.tensor([static])
    codes, scale = fb.ln_quant_ref(xb, torch.from_numpy(w),
                                   torch.from_numpy(b), st)
    y = jfb._ln(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                jnp.asarray(w), jnp.asarray(b))
    want_c, want_s = _jax_codes(y, static)
    assert np.abs(want_c).max() <= 127
    diff = np.abs(codes.numpy().astype(np.int32) - want_c)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= CODE_FLIPS_MAX
    scale = np.broadcast_to(scale.numpy(), (ROWS,))
    assert np.max(np.abs(scale - want_s) / want_s) <= SCALE_TOL
