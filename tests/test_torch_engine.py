"""The port's engine layer against the reference's: the farthest-point
reseed, the host-loop stack solve with empty-cluster reseeding, and the
single solve.  Same numpy inputs, made from a seed, go to both packages;
the reference's fused engine runs its Pallas kernel in interpret mode.

Tolerances: iteration counts, reseed picks and ``take`` masks exact (the
picks are copies of points); centroids and SSE rtol 1e-4 with atol 1e-4,
because the per-cluster sums are f32 sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans as jkmeans
from repro.core.kmeans import kmeans_batched as jkmeans_batched
from repro.kernels import engine as jengine
from repro.kernels import ref as jref
from repro_torch.core.kmeans import KMeansParams, kmeans, kmeans_batched
from repro_torch.kernels import engine, ref

RTOL, ATOL = 1e-4, 1e-4
# reference engine name for each of the port's
JNAME = {"fused": "fused", "eager": "jnp"}


@pytest.mark.parametrize("case", ["ties", "exhausted", "minus_inf_rows"])
def test_reseed_farthest_matches_reference(case):
    rng = np.random.default_rng(3)
    n, d, k = 12, 3, 8
    pts = rng.normal(size=(n, d)).astype(np.float32)
    score = rng.random(n).astype(np.float32)
    empty = np.zeros(k, bool)
    empty[[1, 4, 6]] = True
    kk = k
    if case == "ties":
        score[[2, 5, 9]] = 2.0                  # lowest row must go first
    elif case == "exhausted":
        kk = 2                                  # third empty keeps its seed
    else:
        score[:] = -np.inf
        score[[7, 10]] = [0.5, 0.25]            # only two finite candidates
    j_take, j_picks = jref.reseed_farthest(jnp.asarray(pts),
                                           jnp.asarray(score),
                                           jnp.asarray(empty), kk)
    take, picks = ref.reseed_farthest(torch.from_numpy(pts),
                                      torch.from_numpy(score),
                                      torch.from_numpy(empty), kk)
    np.testing.assert_array_equal(take.numpy(), np.asarray(j_take))
    jt = np.asarray(j_take)
    np.testing.assert_array_equal(picks.numpy()[jt], np.asarray(j_picks)[jt])


def _far_init(d, k):
    """Seeds far outside the data: early iterations leave clusters empty."""
    rng = np.random.default_rng(99)
    return (rng.normal(size=(k, d)) * 5 + 100.0).astype(np.float32)


def test_reseed_empty_clusters_matches_reference():
    rng = np.random.default_rng(5)
    m, s, d, k = 3, 64, 4, 6
    pts = (rng.normal(size=(m, s, d)) * 3).astype(np.float32)
    w = np.ones((m, s), np.float32)
    w[1, 40:] = 0.0
    cents = (rng.normal(size=(m, k, d)) * 3).astype(np.float32)
    cents[0, :3] = 500.0
    counts = np.full((m, k), 5.0, np.float32)
    counts[0, :3] = 0.0                      # lane 0: three empty clusters
    counts[1, 5] = 0.0                       # lane 1: one, with a padded tail
    port = engine.reseed_empty_clusters(
        engine.get_engine("fused"), torch.from_numpy(pts),
        torch.from_numpy(w), torch.from_numpy(cents.copy()),
        torch.from_numpy(counts))
    fused = jengine.get_engine("fused")
    for i in range(m):
        want = jengine.reseed_empty_clusters(
            fused, jnp.asarray(pts[i]), jnp.asarray(w[i]),
            jnp.asarray(cents[i]), jnp.asarray(counts[i]))
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(want))
    assert not np.array_equal(port[0].numpy(), cents[0])
    np.testing.assert_array_equal(port[2].numpy(), cents[2])


@pytest.mark.parametrize("backend", ["fused", "eager"])
def test_kmeans_batched_with_reseed_matches_reference(backend):
    """A stack with one all-padding lane and seeds that empty clusters."""
    rng = np.random.default_rng(11)
    m, s, d, k = 3, 96, 4, 5
    subsets = (rng.normal(size=(m, s, d)) * 3).astype(np.float32)
    masks = np.ones((m, s), bool)
    masks[1, 70:] = False
    masks[2, :] = False                      # all padding
    init = _far_init(d, k)
    init[0] = subsets[0, 0]
    jp = JParams(max_iters=20, backend=JNAME[backend], reseed_empty=True)
    want = jkmeans_batched(jnp.asarray(subsets), jnp.asarray(masks),
                           jnp.asarray(init), jp)
    got = kmeans_batched(subsets, masks, init,
                         KMeansParams(max_iters=20, backend=backend,
                                      reseed_empty=True), device="cpu")
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.sse.numpy(), np.asarray(want.sse),
                               rtol=RTOL, atol=ATOL)
    assert np.isinf(float(got.asse[2])) and np.isinf(float(want.asse[2]))
    np.testing.assert_allclose(got.asse.numpy()[:2],
                               np.asarray(want.asse)[:2], rtol=RTOL)


def test_single_kmeans_matches_reference():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(200, 3)) * 3).astype(np.float32)
    mask = rng.random(200) > 0.1
    init = x[:6].copy()
    want = jkmeans(jnp.asarray(x), jnp.asarray(init), jnp.asarray(mask),
                   JParams(max_iters=30, backend="fused"))
    got = kmeans(x, init, mask, KMeansParams(max_iters=30, backend="fused"),
                 device="cpu")
    assert int(got.iters) == int(want.iters)
    np.testing.assert_array_equal(init, x[:6])    # the seeds stay the caller's
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got.asse), float(want.asse), rtol=RTOL)


@pytest.mark.parametrize("name", ["tuned", "pallas"])
def test_unported_engines_raise(name):
    # 'pallas' is the reference's name of the port's 'twopass'
    match = {"tuned": "slice", "pallas": "twopass"}[name]
    with pytest.raises(NotImplementedError, match=match):
        engine.get_engine(name)


def test_unported_params_raise():
    x = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="unknown init"):
        kmeans(x, x[:2], params=KMeansParams(init="kmeans+++"), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        kmeans(x, x[:2], params=KMeansParams(backend="fussed"), device="cpu")
    with pytest.raises(ValueError, match="prune"):
        kmeans(x, x[:2], params=KMeansParams(prune="hamerly"), device="cpu")
    assert engine.available() == ("eager", "twopass", "fused", "resident",
                                  "batched")
