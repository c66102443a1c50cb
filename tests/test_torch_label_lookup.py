"""The label-map relabel lookup (kernel K9's plain version) and the port's
``merged_label_map`` against the JAX package, on the CPU. Every comparison
is bit-exact: both sides are integer lookups.

Out-of-range ids read as the JAX package's ``dense[idx]`` reads them on
the CPU: a negative id wraps once, then every id is clamped to the table
(``d[[0, 4, 5, 9, -1]]`` on a 5-entry table reads entries 0, 4, 4, 4, 4).
The kernel is held to its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmerge_tpu.ops import labelprop as jlabelprop
from deepmerge_tpu_torch.ops import labelprop as tlabelprop
from deepmerge_tpu_torch.ops.kernels.label_lookup import (
    label_lookup,
    label_lookup_ref,
)

R = 96
HW = (48, 40)


def _min_member_labels(rs, r, n_clusters, num_real=None):
    """Labels as ``device_merge`` leaves them: each region's cluster's
    smallest member id; phantom regions ``num_real..r-1`` singletons."""
    real = r if num_real is None else num_real
    cluster = rs.randint(0, n_clusters, real)
    first = {}
    for i, c in enumerate(cluster):
        first.setdefault(c, i)
    labels = np.array([first[c] for c in cluster] + list(range(real, r)),
                      np.int32)
    return labels


def test_out_of_range_ids_read_as_jax_does():
    table = np.arange(5, dtype=np.int32) * 10
    ids = np.array([0, 4, 5, 9, -1, -5, -6, -100, 2 ** 31 - 1, -2 ** 31],
                   np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    np.testing.assert_array_equal(want[:5], table[[0, 4, 4, 4, 4]])
    for fn in (label_lookup_ref, label_lookup):
        got = fn(torch.from_numpy(table), torch.from_numpy(ids))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("span", [(0, R), (-R - 3, 2 * R)])
def test_plain_version_matches_jax_gather(span):
    """An (H, W) map into an R-entry table, in range and with ids on both
    sides of it."""
    rs = np.random.RandomState(span[0] & 0xFF)
    table = rs.randint(0, 1000, R).astype(np.int32)
    ids = rs.randint(*span, HW).astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = label_lookup(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == HW
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num_real", [None, 80])
@pytest.mark.parametrize("beyond", [False, True])
def test_merged_label_map_matches_jax(num_real, beyond):
    """With and without a bucketed region axis (``num_real``), and on a map
    that also holds ids at and past R."""
    rs = np.random.RandomState(7 + int(beyond))
    labels = _min_member_labels(rs, R, 17, num_real)
    region_map = rs.randint(0, num_real or R, HW).astype(np.int32)
    if beyond:
        region_map[rs.rand(*HW) < 0.1] = R + rs.randint(0, 50)
        region_map[0, :3] = (R, R + 1, 2 ** 31 - 1)
    kw = {} if num_real is None else {"num_real": num_real}
    want_map, want_n = jlabelprop.merged_label_map(
        jnp.asarray(labels), jnp.asarray(region_map), **kw)
    got_map, got_n = tlabelprop.merged_label_map(
        torch.from_numpy(labels), torch.from_numpy(region_map), **kw)
    assert got_map.dtype == torch.int32 and got_map.shape == HW
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    assert int(got_n) == int(want_n)


def test_merged_label_map_takes_an_int64_map():
    """The map is cast to int32 for the lookup (the kernel's type)."""
    rs = np.random.RandomState(3)
    labels = _min_member_labels(rs, R, 9)
    region_map = rs.randint(0, R, HW)
    a, _ = tlabelprop.merged_label_map(torch.from_numpy(labels),
                                       torch.from_numpy(region_map))
    b, _ = tlabelprop.merged_label_map(
        torch.from_numpy(labels), torch.from_numpy(region_map.astype(
            np.int32)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_lookup_refuses_what_it_does_not_take():
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        label_lookup(torch.zeros(4, dtype=torch.int64), ids)
    with pytest.raises(TypeError):
        label_lookup(torch.zeros(0, dtype=torch.int32), ids)
    with pytest.raises(TypeError):
        label_lookup(torch.zeros(4, dtype=torch.int32), ids.long())
