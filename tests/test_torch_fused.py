"""The port's fused Lloyd pass (its plain version, which is what a CPU
tensor runs) against the reference's Pallas kernel in interpret mode.

Same numpy inputs, made from a seed, go to both packages; the step's
``return_labels`` mode is held against the reference's 5-tuple.  Tolerances:
labels and counts exact (random inputs have no near-ties, and duplicated
centroids tie exactly, where both take the lowest index); sums, sse and
mind rtol 1e-4 with a small atol, because both are f32 sums of the same
terms in another order (XLA's dot and tiles against torch's matmul).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused as jfused
from repro_torch.kernels import fused, ops

RTOL, ATOL = 1e-4, 1e-4


def _case(n, d, k, seed, *, masked=False, empty=False, dup=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) * 3.0).astype(np.float32)
    c = (rng.normal(size=(k, d)) * 3.0).astype(np.float32)
    w = np.ones(n, np.float32)
    if masked:
        w = (rng.random(n) > 0.3).astype(np.float32)
    if empty:
        c[k // 2] = 1e4                      # nothing maps here
    if dup:
        c[k - 1] = c[1]                      # exact tie: 1 must win
    return x, c, w


def _jax_step(x, c, w):
    s, cnt, sse, lab, mind = jfused.lloyd_step_fused(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(w), interpret=True,
        return_labels=True)
    return [np.asarray(a) for a in (s, cnt, sse, lab, mind)]


CASES = {
    "plain": dict(n=300, d=5, k=7),
    "masked": dict(n=300, d=5, k=7, masked=True),
    "ragged_k": dict(n=513, d=9, k=130, masked=True),  # k crosses a block
    "empty_and_dup": dict(n=200, d=4, k=6, empty=True, dup=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_step_and_assign_match_reference(name):
    x, c, w = _case(seed=len(name), **CASES[name])
    j_sums, j_cnt, j_sse, j_lab, j_mind = _jax_step(x, c, w)
    tx, tc, tw = (torch.from_numpy(a) for a in (x, c, w))
    sums, cnt, sse = ops.lloyd_step_fused(tx, tc, tw)
    lab, mind = ops.lloyd_assign_fused(tx, tc)
    # return_labels: the step's own labels and distances from the same pass
    *step, s_lab, s_mind = ops.lloyd_step_fused(tx, tc, tw,
                                                return_labels=True)
    assert all(torch.equal(a, b) for a, b in zip(step, (sums, cnt, sse)))
    np.testing.assert_array_equal(s_lab.numpy(), j_lab)
    np.testing.assert_allclose(s_mind.numpy(), j_mind, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(lab.numpy(), j_lab)
    np.testing.assert_array_equal(cnt.numpy(), j_cnt)
    np.testing.assert_allclose(sums.numpy(), j_sums, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(sse), float(j_sse), rtol=RTOL)
    np.testing.assert_allclose(mind.numpy(), j_mind, rtol=RTOL, atol=ATOL)
    if CASES[name].get("empty"):
        k = c.shape[0]
        assert float(cnt[k // 2]) == 0.0 and float(sums[k // 2].abs().sum()) == 0
    if CASES[name].get("dup"):
        assert not bool((lab == c.shape[0] - 1).any())
        assert bool((lab == 1).any())


def test_lane_stack_matches_per_lane_reference():
    """An M>1 stack in one call against one reference call per lane, with a
    lane subset (``lanes``) picking and ordering the output rows."""
    m, s, d, k = 3, 160, 6, 9
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(m, s, d)) * 3.0).astype(np.float32)
    c = (rng.normal(size=(m, k, d)) * 3.0).astype(np.float32)
    w = (rng.random((m, s)) > 0.2).astype(np.float32)
    w[2, 100:] = 0.0
    tx, tc, tw = (torch.from_numpy(a) for a in (x, c, w))
    out = fused.fused_lloyd(tx, tc, tw)
    asg = fused.fused_lloyd(tx, tc, assign_only=True)
    lanes = torch.tensor([2, 0], dtype=torch.int32)
    sub = fused.fused_lloyd(tx, tc, tw, lanes)
    for i in range(m):
        j_sums, j_cnt, j_sse, j_lab, j_mind = _jax_step(x[i], c[i], w[i])
        np.testing.assert_array_equal(asg.labels[i].numpy(), j_lab)
        np.testing.assert_array_equal(out.counts[i].numpy(), j_cnt)
        np.testing.assert_allclose(out.sums[i].numpy(), j_sums, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(float(out.sse[i]), float(j_sse), rtol=RTOL)
        np.testing.assert_allclose(asg.mind[i].numpy(), j_mind, rtol=RTOL,
                                   atol=ATOL)
    for g, lane in enumerate((2, 0)):
        assert torch.equal(sub.sums[g], out.sums[lane])
        assert torch.equal(sub.counts[g], out.counts[lane])


def test_cpu_tensors_never_touch_the_launch_counter():
    x, c, w = (torch.from_numpy(a) for a in _case(64, 3, 4, 1))
    before = fused.launches
    ops.lloyd_step_fused(x, c, w)
    ops.lloyd_assign_fused(x, c)
    assert fused.launches == before


def test_wrapper_checks_its_inputs():
    x, c, w = (torch.from_numpy(a) for a in _case(64, 3, 4, 2))
    with pytest.raises(ValueError, match="assign_only"):
        fused.fused_lloyd(x[None], c[None], w[None], assign_only=True)
    with pytest.raises(TypeError, match="float32"):
        fused.fused_lloyd(x[None].double(), c[None].double())
    with pytest.raises(ValueError, match="do not fit"):
        fused.fused_lloyd(x[None], c[None, :, :2])
