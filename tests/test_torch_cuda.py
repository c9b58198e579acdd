"""The port's CUDA kernels on the card: the fused pass, the whole-solve
kernel, and the assign, centroid-update and init-sweep kernels against their
plain versions; the whole-solve kernel's bitwise contracts (bounds == exact,
one batched launch == one resident launch per lane, every cluster size ==
one block a lane, forced with ``solve_stack(..., cluster=R)``); the two-pass
step's sums bit for bit the fused pass's, on a stack and on one large lane;
repeat launches bit-identical.  Marked
``cuda``; skips without a card.
Run on a machine with one (no JAX needed, so without the JAX conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ipkmeans import IPKMeansConfig, ipkmeans
from repro_torch.core.kmeans import KMeansParams, kmeans_batched
from repro_torch.kernels import (assign, batch_resident, centroid_update,
                                 engine, fused, init, resident)

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
