"""bfloat16 in the port against the reference: the dtype carry of bf16 points
and seeds through every engine and entry point, and the plain versions of
the four bf16-accumulate kernels (``KernelSpec(acc_dtype="bfloat16")``).

The same numpy inputs, made from a seed and rounded to bfloat16 once, go to
both packages as bfloat16 arrays.  Tolerances:

  * the carry: the port's ``batched`` and ``resident`` bit for bit (the
    reference's own contract, ``tests/test_reseed.py``); every engine
    against the reference's ``jnp`` engine with iterations exact, centroids
    within one bfloat16 ulp (both round the same float32 division, summed
    in another order), dtype bfloat16, SSE rtol 1e-4 (float32 sums);
  * the bf16 kernels' plain versions against the reference's bf16 kernels
    in interpret mode, at the tolerances of the reference's own bf16
    checks (``tests/test_kernels.py``, ``tests/test_tuning.py``): labels
    equal except at near-ties (true distances rtol 5e-2), distances
    rtol/atol 0.3, sums rtol/atol 0.15, counts rtol 1e-5, SSE rtol 5e-2.

One shape per group, so that the reference compiles each program once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init as jinit
from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import kmeans_batched as jkmeans_batched
from repro.core.pkmeans import pkmeans as jpkmeans
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro.kernels.specs import KernelSpec as JSpec
from repro_torch import convert
from repro_torch.core.init import kmeans_plus_plus
from repro_torch.core.ipkmeans import IPKMeansConfig, ipkmeans
from repro_torch.core.kmeans import KMeansParams, kmeans_batched, lloyd_step
from repro_torch.core.pkmeans import pkmeans
from repro_torch.device import as_float
from repro_torch.kernels import assign, centroid_update, fused, init, specs

BF16 = specs.KernelSpec(acc_dtype="bfloat16")
ENGINES = ["eager", "twopass", "fused", "resident", "batched"]


def _bf16(a) -> np.ndarray:
    """A float32 array rounded to bfloat16, as the ``ml_dtypes`` array that
    ``np.asarray`` of a JAX bfloat16 array gives."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _t(a) -> torch.Tensor:
    return as_float(a, torch.device("cpu"))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _within_one_ulp(got, want, what):
    """|got - want| at most one bfloat16 ulp of ``want``."""
    got, want = _f32(got), _f32(want)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > ulp
    assert not bad.any(), (what, got[bad][:5], want[bad][:5])


# ---- the carry: the stack of tests/test_reseed.py:291 ----

M, S, D, K = 4, 32, 4, 5


def _stack():
    rng = np.random.default_rng(291)
    x = _bf16((rng.normal(size=(M, S, D)) * 3.0).astype(np.float32))
    masks = np.ones((M, S), bool)
    masks[2, 20:] = False
    far = _bf16((rng.normal(size=(K, D)) * 5 + 100.0).astype(np.float32))
    return x, masks, far


PARAMS = dict(max_iters=12, reseed_empty=True)


def test_bf16_carry_batched_is_resident_bit_for_bit():
    x, masks, far = _stack()
    p = KMeansParams(**PARAMS)
    bat = kmeans_batched(x, masks, far, p._replace(backend="batched"),
                         device="cpu")
    res = kmeans_batched(x, masks, far, p._replace(backend="resident"),
                         device="cpu")
    assert bat.centroids.dtype == torch.bfloat16
    for field, a, b in zip(bat._fields, bat, res):
        assert a.dtype == b.dtype and torch.equal(a, b), field


_JNP_STACK = {}


def _jnp_stack():
    if not _JNP_STACK:
        x, masks, far = _stack()
        _JNP_STACK["r"] = jkmeans_batched(
            jnp.asarray(x), jnp.asarray(masks), jnp.asarray(far),
            JParams(backend="jnp", **PARAMS))
    return _JNP_STACK["r"]


@pytest.mark.parametrize("backend", ENGINES)
def test_bf16_carry_matches_reference_jnp(backend):
    x, masks, far = _stack()
    want = _jnp_stack()
    assert want.centroids.dtype == jnp.bfloat16
    got = kmeans_batched(x, masks, far,
                         KMeansParams(backend=backend, **PARAMS),
                         device="cpu")
    assert got.centroids.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    _within_one_ulp(got.centroids, want.centroids, backend)
    np.testing.assert_allclose(got.sse.numpy(), _f32(want.sse), rtol=1e-4,
                               err_msg=backend)
    assert got.asse.dtype == torch.float32


def test_bf16_entry_points_match_reference():
    """``pkmeans``, ``lloyd_step`` and ``ipkmeans`` on bf16 points and seeds:
    the seeds' dtype comes back, the iterations are the reference's, the
    centroids within one bf16 ulp; the final SSE (bf16 in both, as the
    reference's ``metrics.sse`` keeps the dtype) within two bf16 ulps
    (rtol 2**-6): the port sums in float32 and rounds once, the
    reference's jitted bfloat16 reduction rounds on the way (one ulp apart
    on this data's eager and jitted reference runs alone)."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-6, 6, size=(8, 4))
    xf = (centers[rng.integers(0, 8, 512)] + rng.normal(size=(512, 4)))
    x = _bf16(xf.astype(np.float32))
    seeds = x[rng.choice(512, 8, replace=False)].copy()
    jp = JParams(max_iters=20, reseed_empty=True)
    want = jpkmeans(jnp.asarray(x), jnp.asarray(seeds), params=jp)
    got = pkmeans(x, seeds, params=KMeansParams(max_iters=20,
                                                reseed_empty=True),
                  device="cpu")
    assert got.centroids.dtype == got.sse.dtype == torch.bfloat16
    assert int(got.iters) == int(want.iters)
    _within_one_ulp(got.centroids, want.centroids, "pkmeans")
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=2**-6)

    new_c, sse = lloyd_step(x, seeds, device="cpu")
    assert new_c.dtype == torch.bfloat16 and sse.dtype == torch.float32

    jcfg = JConfig(num_clusters=8, num_subsets=4,
                   kmeans=JParams(max_iters=20, reseed_empty=True))
    want = jipkmeans(jnp.asarray(x), jnp.asarray(seeds), jax.random.key(0),
                     jcfg)
    cfg = IPKMeansConfig(num_clusters=8, num_subsets=4, kmeans=KMeansParams(
        max_iters=20, reseed_empty=True, backend="batched"))
    got = ipkmeans(x, seeds, cfg, device="cpu")
    assert got.centroids.dtype == got.intermediate.dtype == torch.bfloat16
    assert got.sse.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    _within_one_ulp(got.intermediate, want.intermediate, "ipkmeans")
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=2**-6)


def test_bf16_seeding_matches_reference():
    """k-means++ on bf16 points with the reference's own draws: the same
    rows, returned in bfloat16 (the D^2 masses are the reference's bf16
    distances, summed in float32 and rounded once)."""
    rng = np.random.default_rng(77)
    x = _bf16((rng.normal(size=(256, 4)) * 3.0).astype(np.float32))
    key = jax.random.key(5)
    k0, kk = jax.random.split(key)
    u = [jax.random.uniform(k0, ())]
    for _ in range(1, 6):
        kk, sub = jax.random.split(kk)
        u.append(jax.random.uniform(sub, ()))
    want = jinit.kmeans_plus_plus(jnp.asarray(x), key, 6)
    got = kmeans_plus_plus(_t(x), 6,
                           uniforms=torch.from_numpy(np.array(jnp.stack(u))))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_bf16_arrays_cross_bit_for_bit_and_other_floats_raise():
    x = _bf16(np.linspace(-3, 3, 24, dtype=np.float32).reshape(8, 3) / 7)
    px, pc = convert.tensors_from_numpy(x, x[:2], device="cpu")
    assert px.dtype == pc.dtype == torch.bfloat16
    np.testing.assert_array_equal(px.view(torch.int16).numpy(),
                                  x.view(np.int16))
    half = torch.zeros((8, 3), dtype=torch.float16)
    for bad in (half, half.numpy(), half.double()):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            as_float(bad, torch.device("cpu"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pkmeans(half, half[:2], device="cpu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        assign.assign(half, half[:2])


# ---- the bf16-accumulate kernels: one shape ----

N, KD, KK = 300, 17, 9


def _kernel_inputs():
    rng = np.random.default_rng(43)
    x = (rng.normal(size=(N, KD)) * 3.0).astype(np.float32)
    c = (rng.normal(size=(KK, KD)) * 3.0).astype(np.float32)
    w = (rng.random(N) > 0.2).astype(np.float32)
    return x, c, w


def _near_tie_labels(x, c, got, want):
    """Labels agree except where the two centroids' true distances agree
    within rtol 5e-2 (the reference's own rule for bf16 scores)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if diff.any():
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        rows = np.arange(len(got))[diff]
        np.testing.assert_allclose(d2[rows, got[diff]], d2[rows, want[diff]],
                                   rtol=5e-2)


def test_bf16_assign_plain_matches_reference():
    x, c, _ = _kernel_inputs()
    jl, jm = jops.assign(jnp.asarray(x), jnp.asarray(c),
                         spec=JSpec(acc_dtype="bfloat16"), interpret=True)
    lab, mind = assign.assign(torch.from_numpy(x), torch.from_numpy(c),
                              spec=BF16)
    _near_tie_labels(x, c, lab.numpy(), jl)
    np.testing.assert_allclose(mind.numpy(), np.asarray(jm), rtol=0.3,
                               atol=0.3)


def test_bf16_centroid_update_plain_matches_reference():
    x, c, w = _kernel_inputs()
    labels = np.random.default_rng(5).integers(0, KK, N).astype(np.int32)
    js, jc = jops.centroid_update(jnp.asarray(x), jnp.asarray(labels),
                                  jnp.asarray(w), KK,
                                  spec=JSpec(block_n=128,
                                             acc_dtype="bfloat16"),
                                  interpret=True)
    sums, counts = centroid_update.centroid_update(
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(w),
        KK, spec=specs.KernelSpec(block_n=128, acc_dtype="bfloat16"))
    np.testing.assert_allclose(sums.numpy(), np.asarray(js), rtol=0.15,
                               atol=0.15)
    np.testing.assert_allclose(counts.numpy(), np.asarray(jc), rtol=1e-5)


def test_bf16_fused_step_plain_matches_reference():
    x, c, w = _kernel_inputs()
    js, jc, jsse, jl, jm = jfused.lloyd_step_fused(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(w),
        spec=JSpec(block_n=128, acc_dtype="bfloat16"), interpret=True,
        return_labels=True)
    tx, tc, tw = (torch.from_numpy(a) for a in (x, c, w))
    spec = specs.KernelSpec(block_n=128, acc_dtype="bfloat16")
    out = fused.fused_lloyd(tx[None], tc[None], tw[None], spec=spec,
                            return_labels=True)
    asg = fused.fused_lloyd(tx[None], tc[None], spec=spec, assign_only=True)
    assert torch.equal(asg.labels, out.labels)
    _near_tie_labels(x, c, out.labels[0].numpy(), jl)
    if np.array_equal(out.labels[0].numpy(), np.asarray(jl)):
        np.testing.assert_allclose(out.counts[0].numpy(), np.asarray(jc),
                                   rtol=1e-5)
    assert float(out.counts.sum()) == pytest.approx(float(w.sum()))
    np.testing.assert_allclose(out.sums[0].numpy(), np.asarray(js),
                               rtol=0.15, atol=0.15)
    np.testing.assert_allclose(float(out.sse[0]), float(jsse), rtol=5e-2)
    np.testing.assert_allclose(out.mind[0].numpy(), np.asarray(jm),
                               rtol=0.3, atol=0.3)


def test_bf16_init_sweep_plain_matches_reference():
    x, c, w = _kernel_inputs()
    rng = np.random.default_rng(11)
    u = rng.random(N).astype(np.float32)
    om = (rng.random(N) * 60.0).astype(np.float32)
    valid = np.arange(KK) < KK - 2
    jm, js, jpsi = jops.init_sweep(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(om), jnp.asarray(u),
        jnp.float32(900.0), ell=12.0, cand_valid=jnp.asarray(valid),
        weights=jnp.asarray(w), spec=JSpec(acc_dtype="bfloat16"),
        interpret=True)
    mind, samp, psi = init.init_sweep(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(om),
        torch.from_numpy(u), 900.0, ell=12.0,
        cand_valid=torch.from_numpy(valid), weights=torch.from_numpy(w),
        spec=BF16)
    np.testing.assert_allclose(mind.numpy(), np.asarray(jm), rtol=0.3,
                               atol=0.3)
    np.testing.assert_allclose(float(psi), float(jpsi), rtol=5e-2)
    # a draw may differ only where u * psi_prev sits within the distance
    # tolerance of ell * mind
    differ = samp.numpy() != np.asarray(js)
    gap = np.abs(u * 900.0 - 12.0 * np.asarray(jm))
    assert np.all(gap[differ] <= 12.0 * (0.3 + 0.3 * np.asarray(jm)[differ]))
