"""The port's seeding (``core/init.py``, ``kernels/init.py``) against the
reference's ``repro.core.init`` and ``repro.kernels.init``.

Same numpy inputs, made from a seed, go to both packages.  JAX's random
streams cannot be reproduced in torch, so the draws are made from a JAX key
exactly as the reference splits and consumes it, and handed to the port as
inputs.  The reference's init sweep runs once through its Pallas kernel in
interpret mode, otherwise through its oracle ``ref.init_sweep_ref``.

Tolerances: every seed is an input point, so the chosen rows are exact, and
so are the draws of a sweep (``sampled``) and the candidate counts; mind
rtol 1e-6 (the same f32 expressions; only the dot's summation order
differs); psi rtol 1e-5 (an f32 sum of n terms in another order).  Lloyd
results after seeding: subset ids and iterations exact, SSE rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init as jinit
from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans as jkmeans
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import init
from repro_torch.core.ipkmeans import IPKMeansConfig, ipkmeans
from repro_torch.core.kmeans import KMeansParams, kmeans, kmeans_batched
from repro_torch.kernels import ops

RTOL = 1e-4
ELL = 40.0
N, K = 64, 4
# the pipeline test's key, and the seeding key ipkmeans splits from it; the
# seeding tests use that one too, so the reference's compiled seeding is
# shared between tests
PIPE_KEY = jax.random.key(17)
SEED_KEY = jax.random.split(PIPE_KEY)[1]


def _data(seed, n=N, d=6, k=K):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)))
    return x.astype(np.float32)


X = _data(3)
MASK = np.random.default_rng(4).random(N) > 0.2


def _kpp_uniforms(key, k):
    """The uniforms the reference's k-means++ consumes: the first draw from
    ``split(key)[0]``, then one per later draw from a split chain."""
    k0, kk = jax.random.split(key)
    u = [jax.random.uniform(k0, ())]
    for _ in range(1, k):
        kk, sub = jax.random.split(kk)
        u.append(jax.random.uniform(sub, ()))
    return torch.from_numpy(np.array(jnp.stack(u)))


def _kpar_draws(key, n, k, rounds):
    keys = jax.random.split(key, rounds + 3)
    rows = [jax.random.uniform(keys[2 + r], (n,), jnp.float32)
            for r in range(rounds + 1)]
    return init.KMeansParallelDraws(
        torch.from_numpy(np.array(jax.random.uniform(keys[0], ()))),
        torch.from_numpy(np.array(jnp.stack(rows))),
        _kpp_uniforms(keys[1], k))


def _rows(got, x):
    """Row index of each seed in ``x`` (every seed must be an input point)."""
    eq = np.all(np.asarray(got)[:, None, :] == np.asarray(x)[None], axis=-1)
    assert eq.any(axis=1).all(), "a seed is not an input point"
    return eq.argmax(axis=1)


_jref_sweep = jax.jit(jref.init_sweep_ref, static_argnames=("ell",))


def _sweep_case(case):
    rng = np.random.default_rng(7)
    n, d, c = 96, 6, 5
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    cands = (rng.normal(size=(c, d)) * 3).astype(np.float32)
    old = (rng.random(n) * 40 + 20).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    w = np.ones(n, np.float32)
    valid = None
    psi_prev = float(old.sum())
    if case == "round0":
        old[:] = np.inf
        psi_prev = 0.0
    elif case == "weights":
        w[rng.random(n) < 0.3] = 0.0
    elif case == "padding":
        cands = np.concatenate([cands, np.full((3, d), 1e-3, np.float32)])
        valid = np.arange(c + 3) < c
    elif case == "no_candidates":
        cands = np.zeros((8, d), np.float32)
        valid = np.zeros(8, bool)
    return x, cands, old, u, w, valid, psi_prev


@pytest.mark.parametrize("case", ["interpret", "round0", "weights", "padding",
                                  "no_candidates"])
def test_init_sweep_matches_reference(case):
    x, cands, old, u, w, valid, pp = _sweep_case(case)
    jargs = [jnp.asarray(a) for a in (x, cands, old, u)]
    jkw = dict(cand_valid=None if valid is None else jnp.asarray(valid),
               weights=jnp.asarray(w))
    if case == "interpret":
        want = jops.init_sweep(*jargs, pp, ell=ELL, **jkw)
    else:
        want = _jref_sweep(*jargs, pp, ell=ELL, **jkw)
    want = [np.asarray(a) for a in want]
    t = [torch.from_numpy(a) for a in (x, cands, old, u)]
    tw = torch.from_numpy(w)
    if case == "no_candidates":
        # the port takes the round with no candidate as it is: c = 0
        t[1] = t[1][:0]
        valid = None
    got = ops.init_sweep(*t, pp, ell=ELL, weights=tw, cand_valid=None
                         if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    assert 0 < int(want[1].sum()) < len(u) or case == "round0"
    if case == "round0":
        assert not got[1].any()
    if case == "weights":
        assert not got[1][tw == 0.0].any()
    if case == "no_candidates":
        np.testing.assert_array_equal(got[0].numpy(), old)
    if case == "padding":
        # inert: the same sweep over the valid candidates only
        bare = ops.init_sweep(t[0], t[1][:5].contiguous(), *t[2:], pp,
                              ell=ELL, weights=tw)
        assert all(torch.equal(a, b) for a, b in zip(got, bare))


def test_sample_init_matches_reference():
    x = _data(1)
    key = jax.random.key(3)
    want = jinit.sample_init(jnp.asarray(x), key, 7)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (len(x),))))
    got = init.sample_init(torch.from_numpy(x), 7, uniforms=u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["weighted", "duplicates", "zero_weights"])
def test_kmeans_plus_plus_matches_reference(case):
    x = _data(2, n=48)
    w = np.random.default_rng(2).random(len(x)).astype(np.float32)
    k = 6
    if case == "duplicates":
        # 3 distinct rows, k > 3; integer coordinates keep every distance
        # exact, so the residual mass is exactly 0 after the third pick in
        # both packages and the fallbacks decide
        x = np.repeat(np.round(x[:3]), 16, axis=0)
        w = np.ones(len(x), np.float32)
    elif case == "zero_weights":
        w[4:] = 0.0                            # 4 rows carry mass, k > 4
    key = jax.random.key(5)
    want = jinit.kmeans_plus_plus(jnp.asarray(x), key, k,
                                  weights=jnp.asarray(w))
    got = init.kmeans_plus_plus(torch.from_numpy(x), k,
                                weights=torch.from_numpy(w),
                                uniforms=_kpp_uniforms(key, k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case != "duplicates":
        assert len(set(_rows(got, x).tolist())) == k


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_kmeans_parallel_init_matches_reference(backend):
    """The "ref" case is weighted by ``MASK``, as ``kmeans`` weights it."""
    w = MASK.astype(np.float32) if backend == "ref" else None
    want, jstats = jinit.kmeans_parallel_init(
        jnp.asarray(X), SEED_KEY, K, backend=backend, return_stats=True,
        weights=None if w is None else jnp.asarray(w))
    rounds = jstats["rounds"]
    assert rounds == init.default_rounds(N, K)
    got, stats = init.kmeans_parallel_init(
        torch.from_numpy(X), K, draws=_kpar_draws(SEED_KEY, N, K, rounds),
        weights=None if w is None else torch.from_numpy(w),
        backend="plain" if backend == "ref" else "kernel", return_stats=True)
    assert stats["candidates"] == jstats["candidates"]
    np.testing.assert_allclose(stats["psi"], jstats["psi"], rtol=1e-5)
    np.testing.assert_array_equal(_rows(got, X), _rows(np.asarray(want), X))


@pytest.mark.parametrize("method", ["sample", "kmeans++", "kmeans||"])
def test_kmeans_seeding_matches_reference(method):
    """``kmeans(init=...)``: the mask weights the seeding (kmeans++ and
    kmeans||), and the seeds go on to the same Lloyd solve."""
    want = jkmeans(jnp.asarray(X), None, jnp.asarray(MASK),
                   JParams(max_iters=30, init=method), key=SEED_KEY, k=K)
    if method == "sample":
        draws = torch.from_numpy(
            np.array(jax.random.uniform(SEED_KEY, (N,))))
    elif method == "kmeans++":
        draws = _kpp_uniforms(SEED_KEY, K)
    else:
        draws = _kpar_draws(SEED_KEY, N, K, init.default_rounds(N, K))
    got = kmeans(X, None, MASK, KMeansParams(max_iters=30, init=method), k=K,
                 draws=draws, device="cpu")
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


def test_ipkmeans_kmeans_parallel_matches_reference():
    """The reference seeds from ``split(key)[1]`` before S1; ``fused``
    implies the kernel sweep in both packages."""
    jcfg = JConfig(num_clusters=K, num_subsets=4,
                   kmeans=JParams(max_iters=30, backend="fused",
                                  reseed_empty=True)).with_init("kmeans||")
    want = jipkmeans(jnp.asarray(X), None, PIPE_KEY, jcfg)
    cfg = convert.config_from_reference(
        {**dataclasses.asdict(jcfg), "kmeans": jcfg.kmeans._asdict()})
    assert cfg.init == "kmeans||"
    got = ipkmeans(X, None, cfg, device="cpu",
                   draws=_kpar_draws(SEED_KEY, N, K,
                                     init.default_rounds(N, K)))
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    np.testing.assert_allclose(got.intermediate.numpy(),
                               np.asarray(want.intermediate), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


def test_seeding_draws_from_a_generator_and_checks_its_inputs():
    x = torch.from_numpy(_data(6))
    for method in ("sample", "kmeans++", "kmeans||"):
        a = init.resolve_init(x, 5, method,
                              generator=torch.Generator().manual_seed(1))
        b = init.resolve_init(x, 5, method,
                              generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        assert len(set(_rows(a, x).tolist())) == 5
    with pytest.raises(ValueError, match="Generator"):
        init.resolve_init(x, 5, "kmeans||")
    with pytest.raises(ValueError, match="unknown init method"):
        init.resolve_init(x, 5, "given")
    with pytest.raises(ValueError, match="Generator"):
        kmeans(x, None, params=KMeansParams(init="sample"), k=5, device="cpu")
    with pytest.raises(ValueError, match="init='given'"):
        kmeans_batched(x[None], None, x[:5], KMeansParams(init="sample"),
                       device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        IPKMeansConfig(num_clusters=4, num_subsets=2).with_init("kmeans+")
    with pytest.raises(ValueError, match="needs init_centroids"):
        ipkmeans(x, None, IPKMeansConfig(num_clusters=4, num_subsets=2),
                 device="cpu")
