"""The int4 dot probe's plain version (kernel K10) against
``jax.lax.dot_general(..., preferred_element_type=jnp.int32)`` on the CPU,
at M 64, K 128, N 96, in the TPU probe's operand ranges (int8 in
[-100, 100), int4 in [-7, 7]); exact, as integer products must be. XLA's
CPU backend refuses an int4 x int4 dot, so the s4 x s4 variant is held to
the dot of the same values as int8 (the widening is exact). Also the
``pack_int4`` round trip. The kernels are held to this plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu_torch.ops.kernels.int4_dot import (
    VARIANTS,
    int4_dot,
    int4_dot_ref,
    pack_int4,
    unpack_int4,
)

M, K, N = 64, 128, 96
DN = (((1,), (0,)), ((), ()))


def _operands(variant, seed):
    rs = np.random.default_rng(seed)
    a_lim = 8 if variant == "s4s4" else 100
    b_lim = 100 if variant == "s8s8" else 8
    lo = lambda lim: -7 if lim == 8 else -lim
    a = rs.integers(lo(a_lim), a_lim, (M, K), dtype=np.int8)
    b = rs.integers(lo(b_lim), b_lim, (K, N), dtype=np.int8)
    return a, b


def _jax(a, b, variant):
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if variant == "s8s4":
        jb = jb.astype(jnp.int4)
    elif variant == "s4s4":
        ja = ja.astype(jnp.int4).astype(jnp.int8)
        jb = jb.astype(jnp.int4).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        ja, jb, DN, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_version_matches_jax_dot(variant):
    a, b = _operands(variant, VARIANTS.index(variant))
    ta, tbt = torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))
    if variant == "s4s4":
        ta = pack_int4(ta)
    if variant != "s8s8":
        tbt = pack_int4(tbt)
    want = _jax(a, b, variant)
    for fn in (int4_dot_ref, int4_dot):
        got = fn(ta, tbt, variant)
        assert got.dtype == torch.int32 and got.shape == (M, N)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_int4_round_trip_and_nibble_order():
    x = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)
    p = pack_int4(x)
    assert p.dtype == torch.uint8 and p.shape == (3, 16)
    torch.testing.assert_close(unpack_int4(p), x, rtol=0, atol=0)
    # the even index in the low nibble: (-8, -7) -> 0x98
    assert int(p[0, 0]) == 0x98
    with pytest.raises(ValueError):
        pack_int4(torch.tensor([8, 0], dtype=torch.int8))


def test_int4_dot_refuses_what_it_does_not_take():
    a = torch.zeros((128, 64), dtype=torch.int8)
    with pytest.raises(ValueError):
        int4_dot(a, a, "s4s8")
    with pytest.raises(TypeError):
        int4_dot(a, a, "s4s4")
    with pytest.raises(ValueError):
        int4_dot(a, torch.zeros((128, 64), dtype=torch.uint8), "s8s4")
