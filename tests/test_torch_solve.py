"""The port's whole-solve path (``kernels/batch_resident.py``,
``kernels/resident.py``, the ``batched`` and ``resident`` engines and the
solve oracles) against the reference's.

Same numpy inputs, made from a seed, go to both packages.  The reference's
whole-solve kernels run in interpret mode (``group_t=1`` for the stack, the
group size whose per-lane skipping the port's kernel has); a CPU tensor runs
the port's plain version, ``lloyd_solve_plain``.

Tolerances: iteration counts, convergence flags, skip counters, subset ids
exact; centroids and SSE rtol 1e-4 with atol 1e-4, because the per-cluster
sums and the SSE are f32 sums of the same terms in another order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans_batched as jkmeans_batched
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core.ipkmeans import ipkmeans
from repro_torch.core.kmeans import KMeansParams, kmeans, kmeans_batched
from repro_torch.kernels import batch_resident, engine, ops, ref, resident

RTOL, ATOL = 1e-4, 1e-4


def _stack(m, s, d, k, seed):
    """A stack with ragged masks, one all-padding lane and duplicated
    seeds (an empty cluster on the first trip, so reseed fires)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, (m, s))]
         + rng.normal(size=(m, s, d))).astype(np.float32)
    c = x[0, :k].copy()
    c[k - 1] = c[0]
    w = np.ones((m, s), np.float32)
    w[1, s // 2:] = 0.0
    w[2] = 0.0
    return x, c, w


def _ref_batched(x, c, w, **kw):
    out = jops.lloyd_solve_batched(jnp.asarray(x), jnp.asarray(c),
                                   jnp.asarray(w), interpret=True, group_t=1,
                                   return_skips=True, **kw)
    return [np.asarray(a) for a in out]


def _check(got, want, skips=True):
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    if skips:
        np.testing.assert_array_equal(got[4].numpy(), want[4])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prune", ["none", "bounds"])
@pytest.mark.parametrize("reseed", [False, True])
@pytest.mark.parametrize("shape", [(3, 40, 5, 4), (4, 64, 8, 6)])
def test_batched_matches_reference(shape, reseed, prune):
    x, c, w = _stack(*shape, seed=sum(shape))
    kw = dict(max_iters=20, reseed_empty=reseed, prune=prune)
    want = _ref_batched(x, c, w, **kw)
    got = ops.lloyd_solve_batched(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.from_numpy(w), return_skips=True,
                                  **kw)
    _check(got, want)
    assert int(got[2][2]) == 1 and float(got[1][2]) == 0.0   # all padding


@pytest.mark.parametrize("case", ["max_iters", "bound_block",
                                  "one_centroid"])
def test_batched_edge_cases_match_reference(case):
    x, c, w = _stack(4, 64, 8, 6, seed=5)
    kw = dict(max_iters=20, reseed_empty=True, prune="bounds")
    if case == "max_iters":
        kw["max_iters"] = 2
    elif case == "bound_block":
        kw["bound_block"] = 16
    else:
        c = c[:1]
    want = _ref_batched(x, c, w, **kw)
    got = ops.lloyd_solve_batched(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.from_numpy(w), return_skips=True,
                                  **kw)
    _check(got, want)
    if case == "max_iters":
        assert int(got[2].max()) == 2 and not bool(got[3][0])
    elif case == "bound_block":
        assert int(got[4][:, 0].sum()) > 0        # some blocks skipped
        assert int(got[4][0, 1]) == 4 * 4     # 4 blocks, 4 lanes on trip 1


@pytest.mark.parametrize("reseed,prune,block", [(False, "none", None),
                                                (True, "bounds", 16)])
def test_resident_matches_reference(reseed, prune, block):
    x, c, w = _stack(3, 64, 8, 6, seed=9)
    kw = dict(max_iters=20, reseed_empty=reseed, prune=prune,
              bound_block=block)
    want = [np.asarray(a) for a in jops.lloyd_solve_resident(
        jnp.asarray(x[1]), jnp.asarray(c), jnp.asarray(w[1]), interpret=True,
        return_skips=True, **kw)]
    got = resident.lloyd_solve_resident(
        torch.from_numpy(x[1]), torch.from_numpy(c), torch.from_numpy(w[1]),
        return_skips=True, **kw)
    _check(got, want)


def test_bound_helpers_match_reference():
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(3, 7, 5)).astype(np.float32)
    scores[0, 0, 3] = scores[0, 0].min()                 # a tie at the best
    labels = np.argmin(scores, axis=-1).astype(np.int32)
    best = scores.min(-1)
    second = np.asarray(jref.bound_second_best(jnp.asarray(scores),
                                               jnp.asarray(labels)))
    got = ref.bound_second_best(torch.from_numpy(scores),
                                torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), second)
    assert got[0, 0] == best[0, 0]
    valid = rng.random((3, 7)) > 0.3
    want_gap = np.asarray(jref.bound_gap(jnp.asarray(best + 5.0),
                                         jnp.asarray(second + 5.0),
                                         jnp.asarray(valid)))
    gap = ref.bound_gap(torch.from_numpy(best + 5.0),
                        torch.from_numpy(second + 5.0),
                        torch.from_numpy(valid))
    np.testing.assert_allclose(gap.numpy(), want_gap, rtol=1e-6)
    assert np.isinf(gap.numpy()[~valid]).all()
    margin = np.array([-np.inf, 1.0, 2.0, 2.5], np.float32)
    drift = np.array([0.0, 0.5, 1.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        ref.bounds_may_skip(torch.from_numpy(margin),
                            torch.from_numpy(drift)).numpy(),
        np.asarray(jref.bounds_may_skip(jnp.asarray(margin),
                                        jnp.asarray(drift))))


@pytest.mark.parametrize("oracle", ["exact", "bounds"])
def test_solve_oracles_match_reference(oracle):
    x, c, w = _stack(3, 50, 4, 5, seed=12)
    kw = dict(max_iters=15) if oracle == "exact" else dict(max_iters=15,
                                                           block_rows=16)
    jsolve, solve = ((jref.lloyd_solve_ref, ref.lloyd_solve_ref)
                     if oracle == "exact" else
                     (jref.lloyd_solve_bounds_ref, ref.lloyd_solve_bounds_ref))
    jsolve = jax.jit(functools.partial(jsolve, **kw))   # one trace, 3 lanes
    for i in range(3):
        want = jsolve(jnp.asarray(x[i]), jnp.asarray(c), jnp.asarray(w[i]))
        got = solve(torch.from_numpy(x[i]), torch.from_numpy(c),
                    torch.from_numpy(w[i]), **kw)
        _check(got, [np.asarray(a) for a in want], skips=oracle == "bounds")
    # the lane-stacked oracle gives each lane its single-subset solve
    stacked = ref.lloyd_solve_ref(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.from_numpy(w), max_iters=15)
    for i in range(3):
        one = ref.lloyd_solve_ref(torch.from_numpy(x[i]), torch.from_numpy(c),
                                  torch.from_numpy(w[i]), max_iters=15)
        assert int(stacked[2][i]) == int(one[2])
        torch.testing.assert_close(stacked[0][i], one[0], rtol=RTOL,
                                   atol=ATOL)


def test_cpu_tensors_never_touch_the_launch_counters():
    x, c, w = (torch.from_numpy(a) for a in _stack(3, 40, 5, 4, seed=2))
    before = (batch_resident.launches, resident.launches)
    ops.lloyd_solve_batched(x, c, w, max_iters=5)
    ops.lloyd_solve_resident(x[0], c, w[0], max_iters=5)
    assert (batch_resident.launches, resident.launches) == before


def test_plain_version_bounds_is_exact_bit_for_bit():
    x, c, w = _stack(4, 96, 6, 7, seed=21)
    tx, tc, tw = (torch.from_numpy(a) for a in (x, c, w))
    exact = batch_resident.lloyd_solve_plain(tx, tc, tw, max_iters=30,
                                             reseed_empty=True)
    pruned = batch_resident.lloyd_solve_plain(tx, tc, tw, max_iters=30,
                                              reseed_empty=True,
                                              prune="bounds", bound_block=8)
    for a, b in zip(exact[:4], pruned[:4]):
        assert torch.equal(a, b)
    assert int(pruned.skips[:, 0].sum()) > 0
    assert torch.equal(exact.passes, pruned.passes)


@pytest.mark.parametrize("backend", ["batched", "resident"])
def test_kmeans_batched_engines_match_reference(backend):
    x, c, w = _stack(3, 48, 4, 5, seed=30)
    seeds = c.copy()
    masks = w > 0
    want = jkmeans_batched(jnp.asarray(x), jnp.asarray(masks), jnp.asarray(c),
                           JParams(max_iters=20, backend=backend,
                                   reseed_empty=True))
    got = kmeans_batched(x, masks, c, KMeansParams(
        max_iters=20, backend=backend, reseed_empty=True), device="cpu")
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.sse.numpy(), np.asarray(want.sse),
                               rtol=RTOL, atol=ATOL)
    assert np.isinf(float(got.asse[2])) and np.isinf(float(want.asse[2]))
    single = kmeans(x[0], c, masks[0], KMeansParams(
        max_iters=20, backend=backend, reseed_empty=True), device="cpu")
    assert int(single.iters) == int(got.iters[0])
    np.testing.assert_array_equal(c, seeds)       # the seeds stay the caller's


def _data(seed=0, n=2048, d=8, k=16):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)))
    x = x.astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


@pytest.mark.parametrize("prune", ["none", "bounds"])
def test_ipkmeans_batched_matches_reference(prune):
    x, init = _data()
    jcfg = JConfig(num_clusters=16, num_subsets=8,
                   kmeans=JParams(max_iters=50, backend="batched",
                                  reseed_empty=True, prune=prune))
    want = jipkmeans(jnp.asarray(x), jnp.asarray(init), jax.random.key(0),
                     jcfg)
    cfg = convert.config_from_reference(
        {**dataclasses.asdict(jcfg), "kmeans": jcfg.kmeans._asdict()})
    assert (cfg.kmeans.backend, cfg.kmeans.prune) == ("batched", prune)
    got = ipkmeans(*convert.tensors_from_numpy(x, init, device="cpu"), cfg,
                   device="cpu")
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    np.testing.assert_allclose(got.intermediate.numpy(),
                               np.asarray(want.intermediate), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


@pytest.mark.parametrize("backend", ["resident", "batched"])
def test_engines_map_across_unchanged(backend):
    for prune in ("none", "bounds"):
        params = convert.params_from_reference(
            JParams(backend=backend, prune=prune)._asdict())
        assert (params.backend, params.prune) == (backend, prune)
        assert engine.get_engine(params.backend).name == backend


@pytest.mark.parametrize("backend", ["resident", "batched"])
def test_k_beyond_shared_memory_raises(backend):
    k = 20000
    assert not resident.resident_feasible(64, 2, k)
    assert batch_resident.batched_feasible(16384, 64, 1024, prune="bounds")
    x = torch.zeros((1, 64, 2))
    c = torch.zeros((k, 2))
    # the kernel's limit: its wrappers refuse, and the engines fall back
    with pytest.raises(ValueError, match="shared-memory"):
        if backend == "resident":
            ops.lloyd_solve_resident(x[0], c)
        else:
            ops.lloyd_solve_batched(x, c)


@pytest.mark.parametrize("backend", ["resident", "batched"])
def test_k_beyond_shared_memory_falls_back_like_reference(backend):
    """Past the whole-solve kernel's shared memory both engines run the
    fused per-step loop, as the reference's do."""
    k = 20000
    rng = np.random.default_rng(40)
    x = rng.normal(size=(1, 64, 2)).astype(np.float32)
    c = (rng.normal(size=(k, 2)) * 2.0).astype(np.float32)
    assert not batch_resident.batched_feasible(64, 2, k)
    want = jkmeans_batched(jnp.asarray(x), None, jnp.asarray(c),
                           JParams(backend=backend))
    got = kmeans_batched(x, None, c, KMeansParams(backend=backend),
                         device="cpu")
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL)
    np.testing.assert_allclose(got.sse.numpy(), np.asarray(want.sse),
                               rtol=RTOL)


def test_bound_block_rows_matches_reference():
    from repro.kernels.resident import bound_block_rows as jbb
    for n_pad in (8, 40, 64, 1000, 16384, 8 * 997):
        for block in (None, 8, 16, 100, 512):
            assert resident.bound_block_rows(n_pad, block) == jbb(n_pad,
                                                                  block)


@pytest.mark.parametrize("s,prune,bound_block", [
    (16384, "none", None), (16384, "bounds", None), (1000, "bounds", 16),
    (1000, "bounds", None), (8 * 997, "bounds", 512)])
def test_cluster_rows_are_whole_tiles_and_pruning_blocks(s, prune,
                                                         bound_block):
    # the row boundaries the wrapper hands the kernel
    bb, nb = batch_resident._bound_blocks(s, prune, bound_block)
    unit = batch_resident.rank_unit(bb)
    for r in (1, 2, 3, 4, 8, 16):
        rows = batch_resident.cluster_rows(s, unit, r)
        assert len(rows) == r + 1 and rows[0] == 0 and rows[-1] == s
        assert rows == sorted(rows)
        for lo, hi in zip(rows, rows[1:]):
            # whole 128-row tiles, and no pruning block across two ranks
            assert lo % 128 == 0 and (hi % 128 == 0 or hi == s)
            assert not bb or (lo % bb == 0 and (hi % bb == 0 or hi == s))
        if bb:
            owned = sum(-(-hi // bb) - lo // bb
                        for lo, hi in zip(rows, rows[1:]) if hi > lo)
            assert owned == nb


# clusters of each size an H100 holds at once (one block an SM, 132 SMs;
# clusters of 4 to 16 leave part of each GPC idle)
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def test_cluster_size_rule():
    rule = batch_resident.cluster_size
    portable = {**H100_CLUSTERS, 16: 0}
    # a lone lane gets the largest R the card takes, 16 only where allowed
    assert rule(1, 16384, 0, clusters=H100_CLUSTERS) == 16
    assert rule(1, 16384, 256, clusters=portable) == 8
    # the main stack (M = 512): ceil(512 / n) / R is 4 at R = 1 and 2, more
    # at 4, 8 and 16; the tie goes to R = 2
    assert rule(512, 16384, 0, clusters=H100_CLUSTERS) == 2
    assert rule(512, 16384, 256, clusters=H100_CLUSTERS) == 2
    # 48 lanes: 7 waves of 7 lanes at R = 16 (7/16) beat one of 48 at R = 2
    assert rule(48, 16384, 0, clusters=H100_CLUSTERS) == 16
    assert rule(48, 16384, 0, clusters=portable) == 8
    # one lane of one unit (lcm(128, 200) rows > S): no block without rows
    assert rule(1, 1000, 200, clusters=H100_CLUSTERS) == 1
    # a size the card refuses is never chosen
    assert rule(1, 16384, 0, clusters={1: 132, 2: 66, 4: 0, 8: 0,
                                       16: 0}) == 2
    for m in (1, 2, 7, 33, 512, 4096):
        for fits in (H100_CLUSTERS, portable, {1: 132, 2: 0, 4: 0, 8: 0,
                                               16: 0}):
            for s, bb in ((16384, 0), (16384, 256), (1000, 8), (300, 0)):
                r = rule(m, s, bb, clusters=fits)
                units = -(-s // batch_resident.rank_unit(bb))
                assert fits[r] >= 1 and r <= 16 and (r == 1 or r <= units)
                assert r <= 8 or fits[16] >= 1


def test_smem_counts_both_tile_buffers():
    static, tiles = batch_resident._SMEM_STATIC, batch_resident._SMEM_TILES
    # two scoring groups of two buffers, each a point and a centroid tile
    assert tiles == 2 * 2 * 2 * 16 * 132 * 4
    # the sort's start and cursor reuse the tiles; norms or histogram, then
    # one skip flag per pruning block
    assert batch_resident.smem_bytes(16384, 1024, "bounds") == (
        static + tiles + (1024 + 64) * 4)
    assert batch_resident.smem_bytes(64, 16000) == static + 3 * 16000 * 4 + 4
    # the largest k within one block's 227 KB (232,448 bytes)
    kmax = (232448 - static - 4) // 12
    assert batch_resident.batched_feasible(64, 2, kmax)
    assert not batch_resident.batched_feasible(64, 2, kmax + 1)
