"""The rest of the port's single-process S1 and S3 against the reference's:
the histogram builder and labeler, the random variants, the sorted pack,
``hierarchical_merge``, and ``ipkmeans`` with each of them.

Every case shares one shape, n = 256 points in d = 3 at depth 2 (M = 4
subsets of 64, leaf capacity 64, so n == M * capacity), so the reference's
jitted builder, labelers and stack solve compile once for the file.  The
random variants take draws built from a JAX key exactly as the reference
consumes it: ``jax.random.uniform(key, (n,))`` for ``kd_random``,
``jax.random.permutation(key, n)`` for ``random``.  Region ids, subset ids,
packs and iterations must match exactly; merged centroids within rtol 1e-5
(the same f32 arithmetic, elementwise); the pipeline's centroids and SSE
within rtol 1e-4 (atol 1e-4), because per-cluster sums are f32 sums in
another order.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kdtree as jkd
from repro.core import merge as jmerge
from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import _merge_stage as j_merge_stage
from repro.core.ipkmeans import _partition_and_pack as j_partition_and_pack
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans_batched as jkmeans_batched
from repro_torch import convert
from repro_torch.core import kdtree, merge
from repro_torch.core.ipkmeans import _partition_and_pack, ipkmeans

N, D, M, LEAF, DEPTH, K = 256, 3, 4, 64, 2, 4
RTOL = ATOL = 1e-4
KEY = jax.random.key(3)


def _ties(seed=0):
    """Few distinct values per coordinate (long runs of equal keys) and
    both signed zeros on the two split axes, around their medians."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(N, D)) * 1.5).astype(np.float32)
    for a in (0, 1):
        x[::3, a] = -0.0
        x[1::5, a] = 0.0
    return x


def _mixture(seed=1):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(K, D))
    x = (centers[rng.integers(0, K, N)] + rng.normal(size=(N, D)))
    return x.astype(np.float32)


def _draws(strategy):
    """The draws the reference makes from KEY for a random strategy."""
    if strategy == "kd_random":
        return np.asarray(jax.random.uniform(KEY, (N,)))
    return np.asarray(jax.random.permutation(KEY, N)).astype(np.int64)


def test_monotone_key_orders_signed_zeros_like_the_reference():
    """The reference's ``_monotone_u32`` written out in numpy uint32."""
    v = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf],
                 np.float32)
    b = v.view(np.uint32)
    want = np.where((b >> 31) == 1, ~b, b | np.uint32(0x80000000))
    got = kdtree._monotone_u32(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (np.diff(got) > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_builder_matches_reference(seed):
    x = _ties(seed)
    want = np.asarray(jkd.build_kdtree_histogram(jnp.asarray(x), DEPTH))
    region = kdtree.build_kdtree_histogram(torch.from_numpy(x), DEPTH)
    assert region.dtype == torch.int32
    np.testing.assert_array_equal(region.numpy(), want)
    # signed zeros straddle the first median, which the key orders
    col = x[:, 0]
    assert (np.signbit(col) & (col == 0)).any() and \
        (~np.signbit(col) & (col == 0)).any()


@pytest.mark.parametrize("labeler,strategy", [
    ("histogram", "axis"), ("histogram", "random"), ("sort", "random")])
def test_labelers_match_reference(labeler, strategy):
    x = _ties()
    region = np.asarray(jkd.build_kdtree_histogram(jnp.asarray(x), DEPTH))
    jlabel = (jkd.label_regions_histogram if labeler == "histogram"
              else jkd.label_regions)
    label = (kdtree.label_regions_histogram if labeler == "histogram"
             else kdtree.label_regions)
    want = jlabel(jnp.asarray(x), jnp.asarray(region), KEY, 2 ** DEPTH, M,
                  strategy=strategy, label_axis=0)
    u = _draws("kd_random") if strategy == "random" else None
    got = label(torch.from_numpy(x), torch.tensor(region), 2 ** DEPTH, M,
                strategy=strategy, label_axis=0, uniforms=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_partition_and_sorted_pack_match_reference():
    x = _ties()
    want = np.asarray(jkd.random_partition(jnp.asarray(x), KEY, M))
    ids = kdtree.random_partition(torch.from_numpy(x), M,
                                  permutation=_draws("random"))
    np.testing.assert_array_equal(ids.numpy(), want)
    j_out, j_msk = jkd.pack_subsets_sorted(jnp.asarray(x), jnp.asarray(want),
                                           M, N // M)
    out, msk = kdtree.pack_subsets_sorted(torch.from_numpy(x), ids, M, N // M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(j_msk))
    # equal subsets: the sorted pack is the scatter pack, bit for bit
    s_out, s_msk = kdtree.pack_subsets(torch.from_numpy(x), ids, M, N // M)
    assert torch.equal(out, s_out) and torch.equal(msk, s_msk)
    with pytest.raises(ValueError, match="n == num_subsets"):
        kdtree.pack_subsets_sorted(torch.from_numpy(x), ids, M, N // M + 1)


def test_generator_draws_are_valid_partitions():
    x = torch.from_numpy(_ties())
    gen = torch.Generator().manual_seed(0)
    ids = kdtree.random_partition(x, M, generator=gen)
    assert torch.equal(torch.bincount(ids.long()), torch.full((M,), N // M))
    part = kdtree.partition_dataset(x, M, leaf_capacity=LEAF,
                                    strategy="kd_random", generator=gen)
    assert torch.equal(torch.bincount(part.subset_ids.long()),
                       torch.full((M,), N // M))
    with pytest.raises(ValueError, match="Generator"):
        kdtree.partition_dataset(x, M, strategy="random")


@pytest.mark.parametrize("k,ties", [(K, False), (K, True)])
def test_hierarchical_merge_matches_reference(k, ties):
    c = np.random.default_rng(5).normal(size=(M * k, D)).astype(np.float32)
    if ties:
        c = np.round(c * 2.0) / 2.0           # equal distances between pairs
    want = np.asarray(jmerge.hierarchical_merge(jnp.asarray(c), k))
    got = merge.hierarchical_merge(torch.from_numpy(c), k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert merge.hierarchical_merge(torch.from_numpy(c), M * k).shape == \
        (M * k, D)


def test_merge_searches_pick_the_same_pairs():
    """The reference's flat search and the port's row-minima search return
    the same first minimum, ties included, so the merges are
    bit-identical."""
    c = np.random.default_rng(6).normal(size=(64, D)).astype(np.float32)
    c = torch.from_numpy(np.round(c * 2.0) / 2.0)
    flat = merge._merge(c, K, merge._closest_flat)
    rows = merge._merge(c, K, merge._closest_by_rows)
    assert torch.equal(flat, rows)
    assert torch.equal(rows, merge.hierarchical_merge(c, K))


def _as_dict(cfg: JConfig) -> dict:
    return {**dataclasses.asdict(cfg), "kmeans": cfg.kmeans._asdict()}


@pytest.mark.parametrize("change", [
    dict(s1="histogram", pack="sorted", merge="hierarchical"),
    dict(s1="histogram", pack="a2a", merge="hierarchical"),
    dict(partition="kd_random", s1="histogram"),
    dict(partition="kd_random", s1="sort"),
    dict(partition="random", pack="sorted"),
], ids=["histogram-sorted-hierarchical", "histogram-a2a-hierarchical",
        "kd_random-histogram", "kd_random-sort", "random-sorted"])
def test_ipkmeans_variants_match_reference(change):
    """The reference's ``_ipkmeans_core`` stage by stage, outside jit (so
    its jitted pieces compile once for the file), against the port's
    ``ipkmeans``.  The reference's single-process ``pack="a2a"`` scatters,
    and with n == M * capacity the scatter pack is the sorted pack bit for
    bit (asserted above), so the a2a case is held against the reference's
    sorted pack."""
    x = _mixture()
    init = x[np.random.default_rng(2).choice(N, K, replace=False)]
    jcfg = JConfig(num_clusters=K, num_subsets=M, leaf_capacity=LEAF,
                   kmeans=JParams(max_iters=30), **change)
    jx = jnp.asarray(x)
    jpart, jsub, jmsk = j_partition_and_pack(
        jx, KEY, dataclasses.replace(jcfg, pack="sorted")
        if jcfg.pack == "a2a" else jcfg)
    jres = jkmeans_batched(jsub, jmsk, jnp.asarray(init), jcfg.kmeans)
    jfinal, jsse = j_merge_stage(jx, jres, jcfg)

    cfg = convert.config_from_reference(_as_dict(jcfg))
    assert (cfg.partition, cfg.s1, cfg.pack, cfg.merge) == (
        jcfg.partition, jcfg.s1, jcfg.pack, jcfg.merge)
    draws = _draws(cfg.partition) if cfg.partition != "kd_axis" else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ipkmeans(x, init, cfg, partition_draws=draws, device="cpu")
        part, sub, msk = _partition_and_pack(torch.from_numpy(x), cfg,
                                             draws=draws)
    a2a = [w for w in caught if issubclass(w.category, RuntimeWarning)
           and "a2a" in str(w.message)]
    assert len(a2a) == (2 if cfg.pack == "a2a" else 0)
    np.testing.assert_array_equal(part.subset_ids.numpy(),
                                  np.asarray(jpart.subset_ids))
    np.testing.assert_array_equal(part.region_ids.numpy(),
                                  np.asarray(jpart.region_ids))
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(jmsk))
    assert got.kd_depth == jpart.depth
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(jres.iters))
    np.testing.assert_allclose(got.intermediate.numpy(),
                               np.asarray(jres.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(jfinal),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got.sse), float(jsse), rtol=RTOL)
