"""The port's S1 (kd-tree build, axis labeling, scatter pack) against the
reference's: region ids, subset ids, packs and masks must match exactly,
duplicated coordinates (stable tie order) and signed zeros included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kdtree as jkd
from repro_torch.core import kdtree


def _points(n, d, seed, *, ties):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 3.0).astype(np.float32)
    if ties:
        # few distinct values per coordinate: long runs of equal keys, and
        # both signed zeros (the reference's float sort puts -0.0 first)
        x = np.round(x).astype(np.float32)
        x[::7, 0] = -0.0
        x[::5, 0] = 0.0
    return x


@pytest.mark.parametrize("n,d,depth,ties", [
    (1000, 3, 4, False),
    (1000, 3, 5, True),
    (777, 2, 6, True),          # odd n: uneven leaves
])
def test_build_and_label_match_reference(n, d, depth, ties):
    x = _points(n, d, n + depth, ties=ties)
    j_region = np.asarray(jkd.build_kdtree(jnp.asarray(x), depth))
    region = kdtree.build_kdtree(torch.from_numpy(x), depth)
    np.testing.assert_array_equal(region.numpy(), j_region)
    assert region.dtype == torch.int32
    for axis in (0, d - 1):
        j_ids = np.asarray(jkd.label_regions(
            jnp.asarray(x), jnp.asarray(j_region), jax.random.key(0),
            2 ** depth, 6, strategy="axis", label_axis=axis))
        ids = kdtree.label_regions(torch.from_numpy(x), region, 2 ** depth, 6,
                                   label_axis=axis)
        np.testing.assert_array_equal(ids.numpy(), j_ids)


@pytest.mark.parametrize("capacity", [40, 23])      # 23 drops points
def test_pack_subsets_matches_reference(capacity):
    x = _points(300, 4, 3, ties=True)
    ids = np.random.default_rng(4).integers(0, 8, 300).astype(np.int32)
    j_out, j_msk = jkd.pack_subsets(jnp.asarray(x), jnp.asarray(ids), 8,
                                    capacity)
    out, msk = kdtree.pack_subsets(torch.from_numpy(x), torch.from_numpy(ids),
                                   8, capacity)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(j_msk))


@pytest.mark.parametrize("n,m,cap", [(2048, 8, None), (3000, 6, 100),
                                     (500, 16, None)])
def test_partition_dataset_matches_reference(n, m, cap):
    x = _points(n, 3, n, ties=n == 3000)
    j = jkd.partition_dataset(jnp.asarray(x), jax.random.key(0), m,
                              leaf_capacity=cap)
    p = kdtree.partition_dataset(torch.from_numpy(x), m, leaf_capacity=cap)
    assert p.depth == j.depth == kdtree.required_depth(n, cap or m)
    np.testing.assert_array_equal(p.region_ids.numpy(),
                                  np.asarray(j.region_ids))
    np.testing.assert_array_equal(p.subset_ids.numpy(),
                                  np.asarray(j.subset_ids))


def test_unported_s1_variants_raise():
    """The random strategies run from draws or a torch.Generator
    (``tests/test_torch_s1.py``) and refuse to run with neither."""
    x = torch.zeros((16, 2))
    for strategy in ("random", "kd_random"):
        with pytest.raises(ValueError, match="Generator"):
            kdtree.partition_dataset(x, 4, strategy=strategy)
    with pytest.raises(ValueError, match="Generator"):
        kdtree.label_regions(x, torch.zeros(16, dtype=torch.int32), 1, 4,
                             strategy="random")
