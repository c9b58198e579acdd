"""The port's CUDA kernels on the card: the fused pass, the whole-solve
kernel, and the assign, centroid-update and init-sweep kernels against their
plain versions; the whole-solve kernel's bitwise contracts (bounds == exact,
one batched launch == one resident launch per lane, every cluster size ==
one block a lane, forced with ``solve_stack(..., cluster=R)``), also from
per-lane ``(M, k, d)`` seeds; the two-pass
step's sums bit for bit the fused pass's, on a stack and on one large lane;
repeat launches bit-identical; the bf16 kernels (``KernelSpec(acc_dtype=
"bfloat16")``) against their plain versions and the bf16 carry, batched ==
resident == the fused engine's loop bit for bit; the serving tier (every
bucket of ``BucketPolicy()`` bit for bit the unpadded launch, a refresh on
``fused`` the one on ``twopass``, ``tuned`` with an empty tuning cache the
``resident`` engine).  Marked ``cuda``; skips without a card.
Run on a machine with one (no JAX needed, so without the JAX conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ipkmeans import IPKMeansConfig, ipkmeans
from repro_torch.core.kmeans import (KMeansParams, kmeans_batched,
                                     update_minibatch)
from repro_torch.core.serve import BucketPolicy, NearestCentroidServer
from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                 engine, fused, init, ref, resident, specs,
                                 tuning)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ragged(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 1000, 17), generator=g) * 3.0
    c = torch.randn((3, 130, 17), generator=g) * 3.0
    c[:, 7] = c[:, 3]                       # exact tie: 3 must win
    c[:, 11] = 1e3                          # empty cluster
    w = (torch.rand((3, 1000), generator=g) > 0.3).float()
    return x.to(dev), c.to(dev), w.to(dev)


def test_kernel_matches_plain_version(card):
    x, c, w = _ragged(card)
    before = fused.launches
    out = fused.fused_lloyd(x, c, w)
    asg = fused.fused_lloyd(x, c, assign_only=True)
    assert fused.launches == before + 2
    plain = fused.fused_lloyd_plain(x, c, w)
    plain_asg = fused.fused_lloyd_plain(x, c, assign_only=True)
    # random inputs: no near-ties, so labels and counts are exact; sums and
    # sse are f32 sums in another order (rtol 1e-4)
    assert torch.equal(asg.labels, plain_asg.labels)
    assert not bool((asg.labels == 7).any())
    assert torch.equal(out.counts, plain.counts)
    torch.testing.assert_close(out.sums, plain.sums, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out.sse, plain.sse, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(asg.mind, plain_asg.mind, rtol=1e-5,
                               atol=1e-3)


def test_kernel_is_deterministic(card):
    x, c, w = _ragged(card, seed=1)
    a = fused.fused_lloyd(x, c, w)
    b = fused.fused_lloyd(x, c, w)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


def test_pipeline_on_card_matches_cpu(card):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2048, 8)) * 3.0).astype(np.float32)
    init = x[rng.choice(2048, 16, replace=False)]
    cfg = IPKMeansConfig(num_clusters=16, num_subsets=8, kmeans=KMeansParams(
        max_iters=50, backend="fused", reseed_empty=True))
    got = ipkmeans(x, init, cfg, device=card)
    want = ipkmeans(x, init, cfg, device="cpu")
    assert torch.equal(got.subset_iters.cpu(), want.subset_iters)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=1e-4)


def _solve_stack(dev):
    """A ragged stack: ragged masks, one all-padding lane, duplicated seeds
    so that reseed fires; mixture data, so that no score is a near-tie."""
    rng = np.random.default_rng(3)
    m, s, d, k = 5, 1000, 17, 130
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, (m, s))]
         + rng.normal(size=(m, s, d))).astype(np.float32)
    c = x[0, :k].copy()
    c[7] = c[3]
    c[129] = c[50]
    w = (rng.random((m, s)) > 0.3).astype(np.float32)
    w[2] = 0.0
    return (torch.from_numpy(a).to(dev) for a in (x, c, w))


KW = dict(max_iters=50, tol=1e-6, reseed_empty=True)


def _same(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def test_solve_kernel_matches_plain_version(card):
    x, c, w = _solve_stack(card)
    before = batch_resident.launches
    got = batch_resident.lloyd_solve_batched(x, c, w, return_skips=True,
                                             **KW)
    assert batch_resident.launches == before + 1
    want = batch_resident.lloyd_solve_plain(x, c, w, **KW)
    # iterations exact; centroids and sse are f32 sums in another order
    assert torch.equal(got[2], want.iters)
    assert torch.equal(got[3], want.converged)
    torch.testing.assert_close(got[0], want.centroids, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want.sse, rtol=1e-4, atol=0.0)
    assert int(got[2][2]) == 1 and float(got[1][2]) == 0.0   # all padding


def test_solve_bounds_is_exact_bit_for_bit(card):
    x, c, w = _solve_stack(card)
    exact = batch_resident.lloyd_solve_batched(x, c, w, **KW)
    pruned = batch_resident.lloyd_solve_batched(x, c, w, prune="bounds",
                                                bound_block=16, **KW)
    assert all(torch.equal(a, b) for a, b in zip(exact, pruned))


def test_batched_lane_is_resident_solve_bit_for_bit(card):
    x, c, w = _solve_stack(card)
    stack = batch_resident.lloyd_solve_batched(x, c, w, **KW)
    for i in range(x.shape[0]):
        one = resident.lloyd_solve_resident(x[i], c, w[i], **KW)
        assert all(torch.equal(a[i], b) for a, b in zip(stack, one))


def _solve_fields(out, lane=None):
    """A SolveOut's per-lane fields (all but the skip counters)."""
    fields = (out.centroids, out.sse, out.iters, out.converged, out.passes)
    return [f if lane is None else f[lane] for f in fields]


@pytest.mark.parametrize("reseed", [False, True])
def test_solve_kernel_same_bits_at_every_cluster_size(card, reseed):
    # S = 1000: no multiple of R x 128 rows for R > 1, the last block short
    x, c, w = _solve_stack(card)
    kw = {**KW, "reseed_empty": reseed}
    one = batch_resident.solve_stack(x, c, w, cluster=1, **kw)
    for r in (2, 4, 8):
        assert _same(batch_resident.solve_stack(x, c, w, cluster=r, **kw),
                     one), r
    assert _same(batch_resident.solve_stack(x, c, w, **kw), one)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_solve_bounds_is_exact_at_every_cluster_size(card, r):
    x, c, w = _solve_stack(card)
    kw = dict(prune="bounds", bound_block=16, **KW)
    exact = batch_resident.solve_stack(x, c, w, cluster=1, **KW)
    pruned = batch_resident.solve_stack(x, c, w, cluster=r, **kw)
    assert _same(_solve_fields(pruned), _solve_fields(exact))
    # skip counters: integer sums over the blocks, those of one block
    assert torch.equal(pruned.skips, batch_resident.solve_stack(
        x, c, w, cluster=1, **kw).skips)


def test_batched_lane_is_resident_solve_at_any_cluster_size(card):
    x, c, w = _solve_stack(card)
    stack = batch_resident.solve_stack(x, c, w, cluster=2, **KW)
    for i in range(x.shape[0]):
        one = batch_resident.solve_stack(x[i:i + 1], c, w[i:i + 1],
                                         cluster=8, count_as="resident",
                                         **KW)
        assert _same(_solve_fields(stack, i), _solve_fields(one, 0))


def test_solve_cluster_beyond_the_kernel_raises(card):
    x, c, w = _solve_stack(card)
    with pytest.raises(ValueError, match="cluster of 17"):
        batch_resident.solve_stack(x, c, w, cluster=17, **KW)


def test_solve_kernel_at_a_k_whose_sort_outgrows_the_score_tiles(card):
    # k = 9000: the counting sort's start and cursor (2k + 1 words) take
    # more shared memory than the score tiles they reuse
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.normal(size=(2, 600, 8)) * 3.0)
                         .astype(np.float32)).to(card)
    c = torch.from_numpy((rng.normal(size=(9000, 8)) * 3.0)
                         .astype(np.float32)).to(card)
    kw = dict(max_iters=3, tol=1e-6)
    got = batch_resident.solve_stack(x, c, None, cluster=1, **kw)
    want = batch_resident.lloyd_solve_plain(x, c, None, **kw)
    assert torch.equal(got.iters, want.iters)
    torch.testing.assert_close(got.centroids, want.centroids, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.sse, want.sse, rtol=1e-4, atol=0.0)
    for reseed in (False, True):
        one = batch_resident.solve_stack(x, c, None, cluster=1,
                                         reseed_empty=reseed, **kw)
        for r in (2, 4):
            assert _same(batch_resident.solve_stack(
                x, c, None, cluster=r, reseed_empty=reseed, **kw), one), r


@pytest.mark.parametrize("shape,kw", [
    ((3, 40, 5, 4), dict(prune="bounds", bound_block=16)),
    ((4, 64, 8, 6), dict(prune="bounds", bound_block=16, max_iters=2)),
    ((3, 64, 8, 1), dict(prune="bounds")),
    ((3, 64, 8, 6), dict(max_iters=0)),
])
def test_solve_kernel_edge_shapes_match_plain_version(card, shape, kw):
    m, s, d, k = shape
    rng = np.random.default_rng(sum(shape))
    centers = rng.uniform(-6, 6, size=(max(k, 2), d))
    x = (centers[rng.integers(0, max(k, 2), (m, s))]
         + rng.normal(size=(m, s, d))).astype(np.float32)
    w = np.ones((m, s), np.float32)
    w[1, s // 2:] = 0.0
    w[2] = 0.0
    x, c, w = (torch.from_numpy(a).to(card) for a in (x, x[0, :k].copy(), w))
    kw = {**KW, **kw}
    got = batch_resident.solve_stack(x, c, w, **kw)
    want = batch_resident.lloyd_solve_plain(x, c, w, **kw)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.skips, want.skips)
    assert torch.equal(got.passes, want.passes)
    torch.testing.assert_close(got.centroids, want.centroids, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.sse, want.sse, rtol=1e-4, atol=1e-4)


def test_solve_counts_only_launches(card):
    x, c, w = _solve_stack(card)
    before = (batch_resident.launches, resident.launches)
    batch_resident.lloyd_solve_batched(x[:0], c, w[:0], **KW)   # M = 0
    assert (batch_resident.launches, resident.launches) == before
    resident.lloyd_solve_resident(x[0], c, w[0], **KW)
    assert (batch_resident.launches, resident.launches) == (
        before[0], before[1] + 1)


def _per_lane_seeds(x, c):
    """One seed block a lane, each a different cut of the lane's own
    points, the duplicates of the shared seeds kept so that reseed
    fires."""
    m, _, _ = x.shape
    k = c.shape[0]
    seeds = torch.stack([x[(i + 1) % m, 7 * i:7 * i + k] for i in range(m)])
    seeds[:, 7] = seeds[:, 3]
    return seeds.contiguous()


@pytest.mark.parametrize("prune", ["none", "bounds"])
def test_per_lane_seeds_match_plain_version(card, prune):
    x, c, w = _solve_stack(card)
    seeds = _per_lane_seeds(x, c)
    kw = dict(KW, prune=prune)
    before = batch_resident.launches
    got = batch_resident.solve_stack(x, seeds, w, **kw)
    assert batch_resident.launches == before + 1
    want = batch_resident.lloyd_solve_plain(x, seeds, w, **kw)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
    assert torch.equal(got.passes, want.passes)
    torch.testing.assert_close(got.centroids, want.centroids, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(got.sse, want.sse, rtol=1e-4, atol=0.0)
    # the seeds differ, and so do the lanes' solves from the shared seeds
    shared = batch_resident.solve_stack(x, c, w, **kw)
    assert not torch.equal(got.iters, shared.iters) or not torch.equal(
        got.centroids, shared.centroids)


def test_per_lane_seeds_are_resident_solves_bit_for_bit(card):
    x, c, w = _solve_stack(card)
    seeds = _per_lane_seeds(x, c)
    for r in (1, 4):
        stack = batch_resident.solve_stack(x, seeds, w, cluster=r, **KW)
        for i in range(x.shape[0]):
            one = resident.lloyd_solve_resident(x[i], seeds[i], w[i], **KW)
            assert all(torch.equal(a[i], b) for a, b in zip(stack, one)), (
                r, i)
    # shared seeds: the same bits as the same seeds given to every lane
    every = c.expand(x.shape[0], *c.shape).contiguous()
    assert _same(batch_resident.solve_stack(x, c, w, **KW),
                 batch_resident.solve_stack(x, every, w, **KW))


def test_assign_kernel_matches_plain_version_and_fused(card):
    x, c, _ = _ragged(card, seed=2)
    lanes = torch.tensor([2, 0], dtype=torch.int32, device=card)
    before = assign.launches
    got = assign.assign(x, c, lanes)
    assert assign.launches == before + 1
    want = fused.fused_lloyd_plain(x, c, lanes=lanes, assign_only=True)
    assert torch.equal(got.labels, want.labels)          # no near-ties
    assert not bool((got.labels == 7).any())             # 3 wins the tie
    torch.testing.assert_close(got.mind, want.mind, rtol=1e-5, atol=1e-3)
    # the fused pass's scoring code: the same bits, and a repeat too
    assert _same(got, fused.fused_lloyd(x, c, lanes=lanes, assign_only=True))
    assert _same(got, assign.assign(x, c, lanes))
    one = assign.assign(x[1], c[1])                      # one subset
    assert torch.equal(one.labels, fused.fused_lloyd(
        x[1:2], c[1:2], assign_only=True).labels[0])


def test_centroid_update_kernel_matches_plain_version_and_fused(card):
    x, c, w = _ragged(card, seed=3)
    k = c.shape[1]
    lab = fused.fused_lloyd(x, c, assign_only=True).labels
    before = centroid_update.launches
    sums, counts = centroid_update.centroid_update(x, lab, w, k)
    assert centroid_update.launches == before + 1
    # the fused pass's sums on the same labels, bit for bit
    step = fused.fused_lloyd(x, c, w)
    assert torch.equal(sums, step.sums) and torch.equal(counts, step.counts)
    # labels outside [0, k) contribute nothing
    bad = lab.clone()
    bad[:, :50] = -1
    bad[:, 50:90] = k
    got = centroid_update.centroid_update(x, bad, w, k)
    want = centroid_update.centroid_update_plain(
        x, bad, w, k, torch.arange(3, dtype=torch.int32, device=card))
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert _same(got, centroid_update.centroid_update(x, bad, w, k))
    assert float(got[1].sum()) == float(w[:, 90:].sum())


def _update_case(dev, case):
    """(x, c, w, rows, bad) for the centroid-update cases: the labels are
    the fused pass's assign of x against c, then the rows in ``bad`` are
    relabelled -1 or k; ``rows`` forces the chunk size."""
    g = torch.Generator().manual_seed(7)
    rows = {"one_chunk": 1024, "many_chunks": 32, "ragged": 96}.get(case)
    if rows is not None:
        x, c, w = _ragged(dev, seed=7)
        return x, c, w, rows, None
    n, d, k = {"big_lane": (1 << 18, 64, 1000),
               "skewed": (1 << 16, 64, 256)}[case]
    c = torch.randn((1, k, d), generator=g) * 3.0
    x = c[:, torch.randint(0, k, (n,), generator=g)] + torch.randn(
        (1, n, d), generator=g) * 0.3
    w = (torch.rand((1, n), generator=g) > 0.1).float()
    bad = None
    if case == "skewed":
        half = torch.randperm(n, generator=g)
        x[0, half[:n // 2]] = c[0, 0] + torch.randn(
            (n // 2, d), generator=g) * 0.3
        bad = half[n // 2:n // 2 + n // 10]
    return x.to(dev), c.to(dev), w.to(dev), None, bad


@pytest.mark.parametrize("case", ["one_chunk", "many_chunks", "ragged",
                                  "big_lane", "skewed"])
def test_update_kernel_chunks_are_fused_bit_for_bit(card, case):
    x, c, w, rows, bad = _update_case(card, case)
    m, k = x.shape[0], c.shape[1]
    lab = fused.fused_lloyd(x, c, assign_only=True).labels
    w_f = w.clone()
    if bad is not None:
        lab[0, bad[::2]] = -1
        lab[0, bad[1::2]] = k
        w_f[0, bad] = 0.0                  # a zero weight adds exactly 0
        assert float((lab == 0).float().mean()) > 0.45
    before = centroid_update.launches
    sums, counts = centroid_update.centroid_update(x, lab, w, k,
                                                   chunk_rows=rows)
    assert centroid_update.launches == before + 1
    step = fused.fused_lloyd(x, c, w_f)
    assert torch.equal(sums, step.sums) and torch.equal(counts, step.counts)
    plain = centroid_update.centroid_update_plain(
        x, lab, w, k, torch.arange(m, dtype=torch.int32, device=card))
    assert torch.equal(counts, plain[1])
    scale = float(torch.max(torch.abs(plain[0])))
    assert float(torch.max(torch.abs(sums - plain[0]))) <= 1e-5 * scale
    assert _same((sums, counts), centroid_update.centroid_update(
        x, lab, w, k, chunk_rows=rows))


def test_update_kernel_at_a_k_near_its_limit(card):
    """k = 58,000 of the kernel's 58,112 (k counts in one block's shared
    memory); the bits are held against another chunk plan."""
    g = torch.Generator().manual_seed(8)
    k, n, d = 58000, 2000, 17
    x = (torch.randn((1, n, d), generator=g) * 3.0).to(card)
    w = (torch.rand((1, n), generator=g) > 0.2).float().to(card)
    lab = torch.randint(-1, k + 1, (1, n), generator=g,
                        dtype=torch.int32).to(card)
    lab[0, :300] = 5                       # one crowded cluster
    sums, counts = centroid_update.centroid_update(x, lab, w, k)
    plain = centroid_update.centroid_update_plain(
        x, lab, w, k, torch.zeros(1, dtype=torch.int32, device=card))
    assert torch.equal(counts, plain[1])
    scale = float(torch.max(torch.abs(plain[0])))
    assert float(torch.max(torch.abs(sums - plain[0]))) <= 1e-5 * scale
    assert _same((sums, counts), centroid_update.centroid_update(
        x, lab, w, k, chunk_rows=32))
    with pytest.raises(ValueError, match="shared-memory"):
        centroid_update.centroid_update(x, lab, w, 58113)


# an f32 sum of n terms in point order (one warp per cluster, as the bits
# require) against the plain version's blocked sum: each entry within the
# probabilistic bound SEQ_LAMBDA sqrt(n) 2**-24 sum |w x| of either sum
# (Higham and Mary, 2019; an entry fails by chance with probability below
# 2 exp(-18) at 6)
SEQ_LAMBDA = 6.0


def _lane_case(dev, case):
    """One lane of 2**20 rows, d = 16, from a mixture around k = 4100
    centroids (no near-ties); ``skewed``: half its rows next to centroid 0
    and 30% of the weights zero."""
    g = torch.Generator().manual_seed(10)
    n, d, k = 1 << 20, 16, 4100
    c = torch.randn((1, k, d), generator=g) * 3.0
    x = c[:, torch.randint(0, k, (n,), generator=g)] + torch.randn(
        (1, n, d), generator=g) * 0.3
    w = torch.ones((1, n))
    if case == "skewed":
        half = torch.randperm(n, generator=g)[:n // 2]
        x[0, half] = c[0, 0] + torch.randn((n // 2, d), generator=g) * 0.3
        w = (torch.rand((1, n), generator=g) >= 0.3).float()
    return x.to(dev), c.to(dev), w.to(dev)


@pytest.mark.parametrize("case", ["one_lane", "skewed"])
def test_fused_step_on_one_large_lane_is_the_update_bit_for_bit(card, case):
    """The fused step's accumulate is the centroid update's chunked passes:
    on one lane of 2**20 rows, the update kernel's sums and counts on the
    step's labels bit for bit; ``return_labels`` gives the assign-only
    mode's labels and distances bit for bit; a repeat the same bits."""
    x, c, w = _lane_case(card, case)
    k = c.shape[1]
    lanes = torch.zeros(1, dtype=torch.int32, device=card)
    before = fused.launches
    out = fused.fused_lloyd(x, c, w, return_labels=True)
    assert fused.launches == before + 1
    asg = fused.fused_lloyd(x, c, assign_only=True)
    assert torch.equal(out.labels, asg.labels)
    assert torch.equal(out.mind, asg.mind)
    sums, counts = centroid_update.centroid_update(x, asg.labels, w, k)
    assert torch.equal(out.sums, sums) and torch.equal(out.counts, counts)
    assert _same(out, fused.fused_lloyd(x, c, w, return_labels=True))
    assert _same(out[:3], fused.fused_lloyd(x, c, w))
    # the plain versions: labels, counts exact; sums and sse f32 sums in
    # another order
    assert torch.equal(asg.labels, assign.assign_plain(x, c, lanes).labels)
    plain = centroid_update.centroid_update_plain(x, asg.labels, w, k, lanes)
    assert torch.equal(out.counts, plain[1])
    err = torch.abs(out.sums - plain[0])
    if case == "skewed":
        assert float((asg.labels == 0).float().mean()) > 0.45
        terms = centroid_update.centroid_update_plain(
            x, asg.labels, torch.ones_like(w), k, lanes)[1].unsqueeze(-1)
        mag = centroid_update.centroid_update_plain(x.abs(), asg.labels, w,
                                                    k, lanes)[0]
        tol = 2.0 * SEQ_LAMBDA * torch.sqrt(terms) * 2.0 ** -24 * mag
        assert bool((err <= tol).all())
    else:
        assert float(err.max()) <= 1e-5 * float(plain[0].abs().max())
    torch.testing.assert_close(out.sse, torch.sum(w * asg.mind, dim=1),
                               rtol=1e-4, atol=0.0)


def test_fused_step_at_a_large_k_and_past_its_limit(card):
    """k = 40,000: the step's accumulate keeps k counts in one block's
    shared memory, so it takes k up to 58,112 and raises past it."""
    g = torch.Generator().manual_seed(11)
    k, n, d = 40000, 3000, 17
    x = (torch.randn((1, n, d), generator=g) * 3.0).to(card)
    c = (torch.randn((1, k, d), generator=g) * 3.0).to(card)
    w = (torch.rand((1, n), generator=g) > 0.2).float().to(card)
    lanes = torch.zeros(1, dtype=torch.int32, device=card)
    out = fused.fused_lloyd(x, c, w, return_labels=True)
    asg = fused.fused_lloyd(x, c, assign_only=True)
    assert torch.equal(out.labels, asg.labels)
    sums, counts = centroid_update.centroid_update(x, asg.labels, w, k)
    assert torch.equal(out.sums, sums) and torch.equal(out.counts, counts)
    assert _same(out, fused.fused_lloyd(x, c, w, return_labels=True))
    plain = centroid_update.centroid_update_plain(x, asg.labels, w, k, lanes)
    assert torch.equal(out.counts, plain[1])
    scale = float(plain[0].abs().max())
    assert float((out.sums - plain[0]).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(out.sse, torch.sum(w * asg.mind, dim=1),
                               rtol=1e-4, atol=0.0)
    with pytest.raises(ValueError, match="shared-memory"):
        fused.fused_lloyd(x, torch.zeros((1, 58113, d), device=card), w)


@pytest.mark.parametrize("backend", ["resident", "batched"])
def test_whole_solve_engines_fall_back_to_the_fused_kernel(card, backend):
    """Past the whole-solve kernel's shared memory the engines run the
    fused kernel's per-step loop and launch no whole-solve kernel."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((1, 64, 2), generator=g)
    c = torch.randn((20000, 2), generator=g) * 2.0
    before = (fused.launches, batch_resident.launches, resident.launches)
    got = kmeans_batched(x, None, c, KMeansParams(backend=backend),
                         device=card)
    after = (fused.launches, batch_resident.launches, resident.launches)
    assert after[0] > before[0] and after[1:] == before[1:]
    # the fused engine's own solve: the same launches, the same bits
    want = kmeans_batched(x, None, c, KMeansParams(backend="fused"),
                          device=card)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.centroids, want.centroids)
    assert torch.equal(got.sse, want.sse)


@pytest.mark.parametrize("case", ["draw", "round0", "no_candidates",
                                  "padding"])
def test_init_sweep_kernel_matches_plain_version(card, case):
    g = torch.Generator().manual_seed(4)
    n, d, nc = 1000, 17, 37
    x = (torch.randn((n, d), generator=g) * 3.0).to(card)
    cands = (torch.randn((nc, d), generator=g) * 3.0).to(card)
    old = (torch.rand(n, generator=g) * 300 + 100).to(card)
    u = torch.rand(n, generator=g).to(card)
    w = (torch.rand(n, generator=g) > 0.3).float().to(card)
    pp = torch.sum(w * old)
    ell, valid = 40.0, None
    if case == "round0":
        old.fill_(torch.inf)
        pp = 0.0
    elif case == "no_candidates":
        cands = cands[:0]
    elif case == "padding":
        valid = torch.arange(nc, device=card) < 30
    before = init.launches
    got = init.init_sweep(x, cands, old, u, pp, ell=ell, weights=w,
                          cand_valid=valid)
    assert init.launches == before + 1
    want = init.init_sweep(x.cpu(), cands.cpu(), old.cpu(), u.cpu(),
                           torch.as_tensor(pp).cpu(), ell=ell,
                           weights=w.cpu(),
                           cand_valid=None if valid is None else valid.cpu())
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-3)
    assert torch.equal(got[1].cpu(), want[1])            # no draw near 0
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-5, atol=0.0)
    assert _same(got, init.init_sweep(x, cands, old, u, pp, ell=ell,
                                      weights=w, cand_valid=valid))
    if case == "round0":
        assert not bool(got[1].any())
    if case == "no_candidates":
        assert torch.equal(got[0], old) and bool(got[1].any())
    if case == "padding":
        assert _same(got, init.init_sweep(x, cands[:30].contiguous(), old, u,
                                          pp, ell=ell, weights=w))


def test_twopass_step_sums_are_fused_bit_for_bit(card):
    x, c, w = _ragged(card, seed=5)
    lanes = torch.tensor([1, 2], dtype=torch.int32, device=card)
    two = engine.get_engine("twopass").step(x, c, w, lanes)
    one = engine.get_engine("fused").step(x, c, w, lanes)
    assert torch.equal(two[0], one[0]) and torch.equal(two[1], one[1])
    torch.testing.assert_close(two[2], one[2], rtol=1e-5, atol=0.0)


def test_pkmeans_twopass_is_fused_bit_for_bit(card):
    """PKMeans's one lane on ``twopass`` (assign kernel, then the update
    kernel) and on ``fused``: the same labels and sums, so the same
    centroids and iterations bit for bit; the SSE is ``metrics.sse`` of the
    same centroids in both."""
    from repro_torch.core.pkmeans import pkmeans
    g = torch.Generator().manual_seed(7)
    x = (torch.randn((20000, 16), generator=g) * 3.0).to(card)
    c0 = x[:40].clone()
    c0[5] = 1e3                               # empty: the reseed moves it
    mask = (torch.rand(20000, generator=g) > 0.1).to(card)
    out = {}
    for backend in ("twopass", "fused"):
        before = (assign.launches, centroid_update.launches, fused.launches)
        out[backend] = pkmeans(x, c0, mask, KMeansParams(
            max_iters=6, reseed_empty=True, backend=backend), device=card)
        after = (assign.launches, centroid_update.launches, fused.launches)
        launched = [b - a for a, b in zip(before, after)]
        if backend == "twopass":
            assert launched[0] > 0 and launched[1] > 0 and launched[2] == 0
        else:
            assert launched[0] == launched[1] == 0 and launched[2] > 0
    a, b = out["twopass"], out["fused"]
    assert int(a.iters) == int(b.iters) == 6
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.sse, b.sse)


def test_histogram_builder_on_card_matches_cpu(card):
    from repro_torch.core import kdtree
    g = torch.Generator().manual_seed(3)
    x = torch.round(torch.randn((5000, 3), generator=g) * 2.0)
    x[::3, 0] = -0.0                          # signed zeros and duplicates
    x[1::5, 0] = 0.0
    want = kdtree.build_kdtree_histogram(x, 6)
    got = kdtree.build_kdtree_histogram(x.to(card), 6)
    assert torch.equal(got.cpu(), want)
    ids = kdtree.label_regions_histogram(x, want, 64, 8)
    assert torch.equal(kdtree.label_regions_histogram(
        x.to(card), got, 64, 8).cpu(), ids)


def test_hierarchical_merge_on_card_matches_cpu(card):
    from repro_torch.core import merge
    g = torch.Generator().manual_seed(4)
    c = torch.randn((64, 8), generator=g) * 3.0
    want = merge.hierarchical_merge(c, 8)
    got = merge.hierarchical_merge(c.to(card), 8)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0.0)



# ---- bfloat16: the bf16-accumulate kernels and the bf16 carry ----
# The kernels and their plain versions take the same rounding points but
# sum each dot product and each block's partial sums in float32 in their own
# order, then round to bfloat16, so now and then a rounding lands one
# bfloat16 step apart.  Labels may then differ where the plain version's two
# scores lie within one bfloat16 ulp of the score's largest term (max(|cn|,
# |2 x.c|): one rounding of x.c moves the score by at most that), distances
# by two such ulps plus float32 noise of ||x||^2, and a sum by 2**-7 of its
# rows' absolute weighted sum (two roundings of each block partial, at most
# one bfloat16 step apart).  Float32 arithmetic stays inside those bounds
# too, so the steps are also counted: at most DEPART_SHARE of the rows or
# sum entries, plus DEPART_FLOOR, may depart from the plain version beyond
# float32 noise (1e-5 of ||x||^2 for a distance, of the rows' absolute
# weighted sum for a sum).  The float32 kernels and accumulates over blocks
# of half the rows must fail the same check.

BF16 = specs.KernelSpec(acc_dtype="bfloat16")
DEPART_SHARE, DEPART_FLOOR = 2.0**-10, 2


def _departures_ok(n_dep, n):
    return n_dep <= DEPART_SHARE * n + DEPART_FLOOR


def _bf16_ulp(v):
    mag = torch.clamp(v.abs(), min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bf16_score(xr, cc):
    """The plain bf16 score of rows ``xr (R,d)`` against ``cc (R,d)`` and
    one bf16 ulp of its largest term -> two (R,) tensors."""
    cn = ref.round_bf16(torch.sum(cc.float() * cc.float(), dim=-1))
    dot = ref.round_bf16(torch.sum(ref.round_bf16(xr) * ref.round_bf16(cc),
                                   dim=-1))
    term = torch.maximum(cn.abs(), 2.0 * dot.abs())
    return ref.round_bf16(cn - 2.0 * dot), _bf16_ulp(term)


def _bf16_assign_ok(x, c, got, want, x2_rows=None) -> bool:
    """``got``/``want`` AssignOuts of ``x (L,S,d)`` against ``c (L,k,d)``:
    labels equal but at near-ties, distances within two ulps of the
    score's largest term (plus 1e-5 of ||x||^2), and few rows departing."""
    diff = got.labels != want.labels
    lane, row = torch.nonzero(diff, as_tuple=True)
    if row.numel():
        xr = x[lane, row]
        sk, uk = _bf16_score(xr, c[lane, got.labels[lane, row].long()])
        sp, up = _bf16_score(xr, c[lane, want.labels[lane, row].long()])
        if not bool(torch.all((sk - sp).abs() <= torch.maximum(uk, up))):
            return False
    xn = ref.round_bf16(x) if x2_rows is None else x2_rows.float()
    noise = 1e-5 * torch.sum(xn * xn, dim=-1) + 1e-6
    picked = torch.gather(c, 1, want.labels.long().unsqueeze(-1).expand(
        *want.labels.shape, c.shape[-1]))
    _, ulp = _bf16_score(x.reshape(-1, x.shape[-1]),
                         picked.reshape(-1, c.shape[-1]))
    err = (got.mind - want.mind).abs()
    n_dep = int((diff | (err > noise)).sum())
    return (bool(torch.all(err <= 2.0 * ulp.view(want.mind.shape) + noise))
            and _departures_ok(n_dep, diff.numel()))


def _bf16_sums_ok(x, labels, w, k, got, want) -> bool:
    """Sums within 2**-7 of the rows' absolute weighted sum and few entries
    departing beyond 1e-5 of it, counts equal (0/1 weights)."""
    lanes = torch.arange(labels.shape[0], dtype=torch.int32,
                         device=x.device)
    mag, _ = centroid_update.centroid_update_plain(x.float().abs(), labels,
                                                   w.abs(), k, lanes)
    err = (got[0] - want[0]).abs()
    n_dep = int((err > 1e-5 * mag + 1e-6).sum())
    return (bool(torch.all(err <= 2**-7 * mag * 1.001 + 1e-6))
            and _departures_ok(n_dep, err.numel())
            and torch.equal(got[1], want[1]))


def test_bf16_kernels_match_plain_versions(card):
    x, c, w = _ragged(card, seed=9)
    k = c.shape[1]
    lanes = torch.arange(3, dtype=torch.int32, device=card)
    before = (fused.launches, assign.launches, centroid_update.launches)
    out = fused.fused_lloyd(x, c, w, spec=BF16, return_labels=True)
    asg = assign.assign(x, c, spec=BF16)
    upd = centroid_update.centroid_update(x, out.labels, w, k, spec=BF16)
    assert (fused.launches, assign.launches, centroid_update.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    plain = fused.fused_lloyd_plain(x, c, w, spec=BF16, return_labels=True)
    plain_asg = fused.AssignOut(plain.labels, plain.mind)
    assert _bf16_assign_ok(x, c, fused.AssignOut(out.labels, out.mind),
                           plain_asg)
    asg_plain = assign.assign_plain(x, c, lanes, BF16)
    assert _bf16_assign_ok(x, c, asg, asg_plain, x2_rows=x)
    # the fused step's accumulate is the update's, on its own labels
    assert torch.equal(out.sums, upd[0]) and torch.equal(out.counts, upd[1])
    sums_plain = centroid_update.centroid_update_plain(x, out.labels, w, k,
                                                       lanes, BF16)
    assert _bf16_sums_ok(x, out.labels, w, k, upd, sums_plain)
    torch.testing.assert_close(out.sse, torch.sum(
        ref.round_bf16(w) * out.mind, dim=1), rtol=1e-5, atol=0.0)
    # controls: the f32 kernels, and blocks of half the rows, fail the checks
    out32 = fused.fused_lloyd(x, c, w, return_labels=True)
    assert not _bf16_assign_ok(x, c, fused.AssignOut(out32.labels,
                                                     out32.mind), plain_asg)
    assert not _bf16_assign_ok(x, c, assign.assign(x, c), asg_plain,
                               x2_rows=x)
    assert not _bf16_sums_ok(x, out.labels, w, k, centroid_update
                             .centroid_update(x, out.labels, w, k),
                             sums_plain)
    half = BF16.replace(block_n=BF16.block_n // 2)
    assert not _bf16_sums_ok(x, out.labels, w, k, centroid_update
                             .centroid_update(x, out.labels, w, k, spec=half),
                             sums_plain)
    assert not _bf16_sums_ok(x, out.labels, w, k, fused.fused_lloyd(
        x, c, w, spec=half)[:2], sums_plain)


def test_bf16_inputs_are_their_widened_values_and_repeat_bit_identical(card):
    x, c, w = _ragged(card, seed=10)
    xb, cb, wb = (t.to(torch.bfloat16) for t in (x, c, w))
    k = c.shape[1]
    for spec in (None, BF16):
        a = fused.fused_lloyd(xb, cb, wb, spec=spec, return_labels=True)
        assert _same(a, fused.fused_lloyd(xb.float(), cb.float(), wb.float(),
                                          spec=spec, return_labels=True))
        assert _same(a, fused.fused_lloyd(xb, cb, wb, spec=spec,
                                          return_labels=True))
        u = centroid_update.centroid_update(xb, a.labels, wb, k, spec=spec)
        assert _same(u, centroid_update.centroid_update(
            xb.float(), a.labels, wb.float(), k, spec=spec))
        asg = assign.assign(xb, cb, spec=spec)
        assert _same(asg, assign.assign(xb.float(), cb.float(), spec=spec))
        assert _same(asg, assign.assign(xb, cb, spec=spec))


@pytest.mark.parametrize("case", ["draw", "padding"])
def test_bf16_init_sweep_matches_plain_version(card, case):
    g = torch.Generator().manual_seed(12)
    n, d, nc = 1000, 17, 37
    x = (torch.randn((n, d), generator=g) * 3.0).to(card)
    cands = (torch.randn((nc, d), generator=g) * 3.0).to(card)
    old = (torch.rand(n, generator=g) * 300 + 100).to(card)
    u = torch.rand(n, generator=g).to(card)
    w = (torch.rand(n, generator=g) > 0.3).float().to(card)
    pp, ell = torch.sum(w * old), 40.0
    nv = 30 if case == "padding" else nc
    valid = torch.arange(nc, device=card) < nv
    before = init.launches
    got = init.init_sweep(x, cands, old, u, pp, ell=ell, weights=w,
                          cand_valid=valid, spec=BF16)
    assert init.launches == before + 1
    want = init.init_sweep_plain(x, cands, old, u, pp, ell=ell, weights=w,
                                 cand_valid=valid, spec=BF16)
    # the plain version's best candidate sets the rounding scale
    best = torch.argmin(ref.bf16_scores(x, cands[:nv]), dim=1)
    _, ulp = _bf16_score(x, cands[best])
    noise = 1e-5 * torch.sum(ref.round_bf16(x) ** 2, dim=-1) + 1e-6
    tol = 2.0 * ulp + noise

    def agrees(out):
        err = (out[0] - want[0]).abs()
        return (bool(torch.all(err <= tol))
                and _departures_ok(int((err > noise).sum()), n))

    assert agrees(got)
    # a draw may differ only where u * psi_prev is that close to ell * mind
    differ = got[1] != want[1]
    assert bool(torch.all((u * pp - ell * want[0]).abs()[differ]
                          <= ell * tol[differ]))
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=0.0)
    assert _same(got, init.init_sweep(x, cands, old, u, pp, ell=ell,
                                      weights=w, cand_valid=valid,
                                      spec=BF16))
    # control: the f32 kernel fails the same check
    assert not agrees(init.init_sweep(x, cands, old, u, pp, ell=ell,
                                      weights=w, cand_valid=valid))


def test_bf16_carry_batched_is_resident_and_fused_bit_for_bit(card):
    x, c, w = _solve_stack(card)
    xb, cb = x.to(torch.bfloat16), c.to(torch.bfloat16)
    stack = batch_resident.lloyd_solve_batched(xb, cb, w, **KW)
    assert stack[0].dtype == torch.bfloat16
    for i in (0, 3):
        one = resident.lloyd_solve_resident(xb[i], cb, w[i], **KW)
        assert all(torch.equal(a[i], b) for a, b in zip(stack, one))
    # the fused engine's host loop rounds the same carry: the same bits
    c_f, it_f, _ = engine.get_engine("fused").lloyd_loop(
        xb, cb, w, max_iters=KW["max_iters"], tol=KW["tol"],
        reseed_empty=True)
    assert torch.equal(it_f, stack[2])
    assert torch.equal(c_f.to(torch.bfloat16), stack[0])
    # one trip against the plain version from the same seeds: the division
    # of sums in another f32 order rounds within one bf16 ulp (further
    # trips could part at a near-tie, so only one is held)
    one = dict(KW, max_iters=1)
    got = batch_resident.lloyd_solve_batched(xb, cb, w, **one)
    want = batch_resident.lloyd_solve_plain(xb.cpu(), cb.cpu(), w.cpu(),
                                            **one)
    assert torch.equal(got[2].cpu(), want.iters)
    diff = (got[0].float().cpu() - want.centroids.float()).abs()
    assert bool(torch.all(diff <= _bf16_ulp(want.centroids.float())))


def _hashed(shape, salt: int) -> torch.Tensor:
    """Floats in [-3, 3) from a splitmix64 hash of each element's index and
    ``salt``: inputs that no random generator's version can move."""
    z = (np.arange(int(np.prod(shape)), dtype=np.uint64)
         + np.uint64(salt << 32)) * np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    u = (z >> np.uint64(40)).astype(np.float64) / float(1 << 24)
    return torch.from_numpy(((u - 0.5) * 6.0).astype(np.float32)
                            .reshape(shape))


def _f32_outputs(dev):
    """Every f32 kernel once, on fixed hashed inputs shaped as ``_ragged``
    and ``_solve_stack``'s, through calls that exist unchanged since before
    the bf16 modes."""
    x, c = _hashed((3, 1000, 17), 1), _hashed((3, 130, 17), 2)
    c[:, 7] = c[:, 3]
    c[:, 11] = 1e3
    w = (_hashed((3, 1000), 3) > -1.2).float()
    old = (_hashed((1000,), 4) + 3.0) * 50.0 + 100.0
    u = (_hashed((1000,), 5) + 3.0) / 6.0
    m, s, d, k = 5, 1000, 17, 130
    centers = _hashed((k, d), 6) * 2.0
    pick = ((_hashed((m, s), 7) + 3.0) * (k / 6.0)).long().clamp(0, k - 1)
    xs = centers[pick] + _hashed((m, s, d), 8) / 3.0
    cs = xs[0, :k].clone()
    cs[7] = cs[3]
    cs[129] = cs[50]
    ws = (_hashed((m, s), 9) > -1.2).float()
    ws[2] = 0.0
    x, c, w, old, u, xs, cs, ws = (t.to(dev) for t in (x, c, w, old, u, xs,
                                                       cs, ws))
    step = fused.fused_lloyd(x, c, w)
    return [*step, *assign.assign(x, c),
            *centroid_update.centroid_update(x, step.counts.argmax(-1)[:, None]
                                             .expand(-1, x.shape[1])
                                             .contiguous().int(), w,
                                             c.shape[1]),
            *init.init_sweep(x[0], c[0], old, u, 5000.0, ell=40.0),
            *batch_resident.lloyd_solve_batched(xs, cs, ws, **KW)]


def _digest(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


# the digest of _f32_outputs from the kernels as they were before the bf16
# modes (the f32 instantiations) were added, on an NVIDIA H100 80GB HBM3
# (torch 2.11.0+cu128): the f32 kernels must keep their bits
F32_DIGEST = "4019e53292e18596"


def test_f32_kernels_give_their_earlier_bits(card):
    assert _digest(_f32_outputs(card)) == F32_DIGEST


def _serve_case(dev, seed=0, n=5000, k=1024, d=64):
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand((k, d), generator=g) * 12.0 - 6.0
    q = (centers[torch.randint(0, k, (n,), generator=g)]
         + torch.randn((n, d), generator=g))
    return q.to(dev), centers.to(dev)


def test_serving_buckets_are_the_unpadded_launch_bit_for_bit(card):
    q, c = _serve_case(card)
    server = NearestCentroidServer(c, device=card)
    buckets = BucketPolicy().buckets()
    before, calls = fused.launches, 0
    for n in sorted({1, 3, *(b // 2 + 1 for b in buckets), *buckets, 5000}):
        got = server.assign(q[:n])
        want = engine.get_engine("fused").assign(q[None, :n], c[None])
        assert torch.equal(got[0], want[0][0])
        assert torch.equal(got[1], want[1][0])
        calls += 1 + -(-n // buckets[-1])
    assert fused.launches == before + calls     # one a chunk, one unpadded
    assert server.trace_counts == dict.fromkeys(buckets, 1)
    sizes = (5, 700, 3000, 400, 4096)
    tickets = [server.submit(q[:m]) for m in sizes]
    assert server.step() == tickets[:3] and server.step() == tickets[3:4]
    assert server.step() == tickets[4:] and server.pending == 0
    for t, m in zip(tickets, sizes):
        got, want = server.result(t), server.assign(q[:m])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_refresh_on_fused_is_the_twopass_refresh(card):
    q, c = _serve_case(card, seed=1, k=300)
    g = torch.Generator().manual_seed(2)
    counts = (torch.rand(300, generator=g) * 100).to(card)
    w = (torch.rand(5000, generator=g) > 0.2).float().to(card)
    before = (fused.launches, assign.launches, centroid_update.launches)
    got = update_minibatch(q, c, counts, w, KMeansParams(backend="fused"),
                           device=card)
    two = update_minibatch(q, c, counts, w, KMeansParams(backend="twopass"),
                           device=card)
    assert (fused.launches, assign.launches, centroid_update.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    # the same labels and sums, so the same merge; the SSE is summed in
    # another order by each engine
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    torch.testing.assert_close(got[2], two[2], rtol=1e-5, atol=0.0)
    labels = fused.fused_lloyd(q[None], c[None], assign_only=True).labels[0]
    sums, bcounts = ref.centroid_update_ref(q, labels, w, 300)
    want_c, want_counts = ref.minibatch_merge(c, counts, sums, bcounts)
    assert torch.equal(got[1], want_counts)
    torch.testing.assert_close(got[0], want_c, rtol=1e-5, atol=1e-5)
    plain = ref.minibatch_update_ref(q, c, counts, w)
    torch.testing.assert_close(got[2], plain[2], rtol=1e-5, atol=0.0)
    untouched = bcounts == 0
    assert torch.equal(got[0][untouched], c[untouched])


def test_tuned_without_a_cache_entry_is_resident_bit_for_bit(
        card, monkeypatch, tmp_path):
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(tmp_path / "none.json"))
    tuning.reload_cache()
    x, c, w = _solve_stack(card)
    runs = []
    for name in ("tuned", "resident"):
        before = resident.launches
        runs.append(engine.get_engine(name).solve_batched(x, c, w, **KW))
        runs.append(resident.launches - before)
    assert runs[1] == runs[3] > 0               # the same launches
    assert _same(runs[0], runs[2])
    bf16 = specs.KernelSpec(acc_dtype="bfloat16")
    cache = tuning.TuningCache.load(tmp_path / "bf16.json")
    cache.put(tuning.cache_key(torch.cuda.get_device_name(card),
                               torch.float32, x.shape[1], x.shape[2],
                               c.shape[0]), bf16)
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(cache.save()))
    tuning.reload_cache()
    cs = c.expand(x.shape[0], -1, -1).contiguous()
    step = engine.get_engine("tuned").step(x, cs, w)
    assert _same(step, fused.fused_lloyd(x, cs, w, spec=bf16))
