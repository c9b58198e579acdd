"""The port's ``twopass`` engine and its two kernels (``kernels/assign.py``,
``kernels/centroid_update.py``; their plain versions, which is what a CPU
tensor runs) against the reference's ``pallas`` engine and its Pallas
kernels in interpret mode.

Same numpy inputs, made from a seed, go to both packages.  Tolerances:
labels and counts exact (random inputs have no near-ties; duplicated
centroids tie exactly, and both take the lowest index); mind and sums rtol
1e-5 with a small atol (the same f32 terms summed in another order); Lloyd
results: iterations exact, centroids and SSE rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans as jkmeans
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.ipkmeans import ipkmeans
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import (assign, centroid_update, engine, fused,
                                 init, ops, ref)

RTOL = 1e-4


def _case(seed, n=200, d=5, k=7):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 3.0).astype(np.float32)
    c = (rng.normal(size=(k, d)) * 3.0).astype(np.float32)
    c[k - 1] = c[1]                          # exact tie: 1 must win
    c[k // 2] = 1e4                          # nothing maps here
    w = (rng.random(n) > 0.3).astype(np.float32)
    return x, c, w


def test_assign_and_update_match_reference():
    x, c, w = _case(0)
    k = len(c)
    jl, jm = jops.assign(jnp.asarray(x), jnp.asarray(c))
    lab, mind = ops.assign(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-4)
    assert not (lab == k - 1).any() and not (lab == k // 2).any()
    # labels outside [0, k) contribute nothing, in both packages
    bad = lab.clone()
    bad[:7] = -1
    bad[7:11] = k
    js, jc = jops.centroid_update(jnp.asarray(x), jnp.asarray(bad.numpy()),
                                  jnp.asarray(w), k)
    sums, counts = ops.centroid_update(torch.from_numpy(x), bad,
                                       torch.from_numpy(w), k)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    keep = torch.arange(len(x)) >= 11
    s2, c2 = ops.centroid_update(torch.from_numpy(x)[keep], lab[keep],
                                 torch.from_numpy(w)[keep], k)
    assert torch.equal(counts, c2)
    np.testing.assert_allclose(sums.numpy(), s2.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_lane_stack_matches_per_lane_calls():
    """A stack with ``lanes``: row g of the outputs is lane lanes[g], the
    same as a call on that lane alone."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=(4, 50, 3)) * 3).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(4, 6, 3)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.random((4, 50)) > 0.2).astype(np.float32))
    lanes = torch.tensor([3, 0], dtype=torch.int32)
    lab, mind = assign.assign(x, c, lanes)
    sums, counts = centroid_update.centroid_update(x, lab, w, 6, lanes)
    for g, lane in enumerate(lanes.tolist()):
        one = assign.assign(x[lane], c[lane])
        assert torch.equal(lab[g], one.labels)
        assert torch.equal(mind[g], one.mind)
        s1, c1 = centroid_update.centroid_update(x[lane], one.labels,
                                                 w[lane], 6)
        assert torch.equal(sums[g], s1) and torch.equal(counts[g], c1)


def test_plain_versions_in_row_chunks_match_one_block(monkeypatch):
    """The plain assigns and init sweep give the same labels and draws when
    their scores go in row chunks (``ref.by_row_chunks``) as in one block,
    and distances within a few ulps (the BLAS rounds a 9-row product
    another way than a 100-row one); the plain update, whose one-hot goes
    in row chunks too, the same counts and sums within a few ulps."""
    x, c, w = (torch.from_numpy(a) for a in _case(6, n=100, d=4, k=7))
    u = torch.from_numpy(np.random.default_rng(6).random(100, np.float32))
    old = torch.full((100,), torch.inf)
    lab = ref.assign_ref(x, c)[0]
    lab[:5] = -1

    def outputs():
        return (assign.assign(x, c), ref.assign_ref(x, c),
                ref.init_sweep_ref(x, c, old, u, 50.0, ell=4.0, weights=w),
                centroid_update.centroid_update(x, lab, w, 7))

    whole = outputs()
    monkeypatch.setattr(ref, "PLAIN_SCORE_ELEMS", 7 * 9)   # 9-row chunks
    chunked = outputs()
    close = dict(rtol=1e-6, atol=1e-5)
    for (lab, mind), (lab2, mind2) in zip(whole[:2], chunked[:2]):
        assert torch.equal(lab, lab2)
        torch.testing.assert_close(mind, mind2, **close)
    (mind, drawn, psi), (mind2, drawn2, psi2) = whole[2], chunked[2]
    assert torch.equal(drawn, drawn2)
    torch.testing.assert_close(mind, mind2, **close)
    torch.testing.assert_close(psi, psi2, **close)
    (sums, counts), (sums2, counts2) = whole[3], chunked[3]
    assert torch.equal(counts, counts2)
    torch.testing.assert_close(sums, sums2, **close)


def test_kmeans_twopass_matches_reference_pallas():
    x, c, w = _case(2, n=256, d=4, k=5)
    c = x[:5].copy()
    mask = w > 0
    want = jkmeans(jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask),
                   JParams(max_iters=20, backend="pallas"))
    params = convert.params_from_reference(
        JParams(max_iters=20, backend="pallas")._asdict())
    assert params.backend == "twopass"
    got = kmeans(x, c, mask, params, device="cpu")
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


def test_ipkmeans_twopass_matches_reference_pallas():
    rng = np.random.default_rng(3)
    centers = rng.uniform(-6, 6, size=(8, 4))
    x = (centers[rng.integers(0, 8, 256)]
         + rng.normal(size=(256, 4))).astype(np.float32)
    init_c = x[rng.choice(256, 4, replace=False)]
    jcfg = JConfig(num_clusters=4, num_subsets=4,
                   kmeans=JParams(max_iters=20, backend="pallas",
                                  reseed_empty=True))
    want = jipkmeans(jnp.asarray(x), jnp.asarray(init_c), jax.random.key(0),
                     jcfg)
    cfg = convert.config_from_reference(
        {**dataclasses.asdict(jcfg), "kmeans": jcfg.kmeans._asdict()})
    assert cfg.kmeans.backend == "twopass"
    seeded = jcfg.with_init("kmeans||")
    assert convert.config_from_reference(
        {**dataclasses.asdict(seeded), "kmeans": seeded.kmeans._asdict()}
    ) == cfg.with_init("kmeans||")
    got = ipkmeans(x, init_c, cfg, device="cpu")
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    np.testing.assert_allclose(got.intermediate.numpy(),
                               np.asarray(want.intermediate), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)
    # the same stack on the fused engine: the same labels and sums
    fused_res = ipkmeans(x, init_c, cfg.with_backend("fused"), device="cpu")
    assert torch.equal(fused_res.subset_iters, got.subset_iters)


def test_cpu_tensors_never_touch_the_launch_counters():
    x, c, w = (torch.from_numpy(a) for a in _case(4, n=64, d=3, k=4))
    before = (assign.launches, centroid_update.launches, init.launches,
              fused.launches)
    step = engine.get_engine("twopass").step(x[None], c[None], w[None])
    ops.init_sweep(x, c, torch.full((64,), torch.inf), torch.rand(64), 1.0,
                   ell=4.0)
    assert (assign.launches, centroid_update.launches, init.launches,
            fused.launches) == before
    want = fused.fused_lloyd_plain(x[None], c[None], w[None])
    assert torch.equal(step[1], want.counts)


def test_wrappers_check_their_inputs():
    x, c, w = (torch.from_numpy(a) for a in _case(5, n=64, d=3, k=4))
    lab = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(TypeError, match="assign takes float32"):
        assign.assign(x.double(), c.double())
    with pytest.raises(ValueError, match="do not fit"):
        assign.assign(x, c[:, :2])
    with pytest.raises(TypeError, match="int32 labels"):
        centroid_update.centroid_update(x, lab.long(), w, 4)
    with pytest.raises(ValueError, match="k must be"):
        centroid_update.centroid_update(x, lab, w, 0)
    with pytest.raises(ValueError, match="does not fit"):
        init.init_sweep(x, c, w[:10], w, 1.0, ell=2.0)
    with pytest.raises(ValueError, match="cand_valid"):
        init.init_sweep(x, c, w, w, 1.0, ell=2.0,
                        cand_valid=torch.ones(3, dtype=torch.bool))


@pytest.mark.parametrize("n_lanes", [1, 512])
def test_chunk_plan_covers_every_row_once(n_lanes):
    """The centroid-update kernel's chunks: every row of [0, S) in exactly
    one chunk, whole multiples of 32 rows but the last, and enough chunks
    for two blocks an SM of a 132-SM card where 32-row chunks allow it."""
    sms = 132
    for s in (1, 31, 32, 4097, 1 << 20):
        plan = centroid_update.chunk_plan(n_lanes, s, sms)
        # chunk c is rows [c C, min((c + 1) C, S)), as the kernel cuts them
        b = [min(c * plan.rows, s) for c in range(plan.chunks + 1)]
        assert len(b) == plan.chunks + 1 and b[0] == 0 and b[-1] == s
        sizes = np.diff(b)
        assert (sizes > 0).all() and sizes.sum() == s
        assert (sizes[:-1] == plan.rows).all() and sizes[-1] <= plan.rows
        assert plan.rows % 32 == 0
        assert plan.rows <= centroid_update.CHUNK_ROWS
        assert plan.chunks == -(-s // plan.rows)
        assert plan.segs == -(-plan.chunks // centroid_update.CHUNK_SEG)
        assert n_lanes * plan.chunks >= min(2 * sms, n_lanes * -(-s // 32))
    assert centroid_update.chunk_plan(1, 4097, sms, rows=64).chunks == 65
    with pytest.raises(ValueError, match="multiple of 32"):
        centroid_update.chunk_plan(1, 100, sms, rows=48)
