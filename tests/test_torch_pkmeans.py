"""The port's PKMeans baseline (``core/pkmeans.py``) and ``lloyd_step``
against the reference's ``repro.core.pkmeans.pkmeans`` and
``repro.core.kmeans.lloyd_step`` on its ``jnp`` engine.

One shape for the file, the reference's own empty-cluster case
(``tests/test_engines.py::test_reseed_empty_in_pkmeans``: two Gaussian
blobs of 60 points, the second at (10, 10), and the seeds (0, 0), (0.5,
0.5) and (500, 500), the last of which no point takes), drawn with numpy,
so the
reference compiles once per reseed setting: the unmasked port run is held
against the reference's run with an all-True mask, whose weights of 1.0
give the same sums bit for bit.  Every port engine runs each case on its
plain versions.  Iterations and convergence exact;
centroids and SSE within rtol 1e-4 (atol 1e-4), because per-cluster sums
are f32 sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kmeans import KMeansParams as JParams
from repro.core.kmeans import lloyd_step as jlloyd_step
from repro.core.pkmeans import pkmeans as jpkmeans
from repro_torch import PKMeansResult, pkmeans
from repro_torch.core import KMeansParams, lloyd_step
from repro_torch.core.pkmeans import pkmeans_sharded
from repro_torch.kernels import engine

RTOL = ATOL = 1e-4
ENGINES = ("eager", "twopass", "fused", "resident", "batched")


def _data():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(size=(60, 2)),
                          rng.normal(size=(60, 2)) + 10.0])
    init = np.array([[0.0, 0.0], [0.5, 0.5], [500.0, 500.0]], np.float32)
    mask = rng.random(len(pts)) > 0.25
    return pts.astype(np.float32), init, mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("reseed", [False, True], ids=["keep", "reseed"])
def test_pkmeans_matches_reference_on_every_engine(masked, reseed):
    pts, init, mask = _data()
    m = mask if masked else None
    want = jpkmeans(jnp.asarray(pts), jnp.asarray(init),
                    jnp.asarray(mask if masked else np.ones_like(mask)),
                    params=JParams(max_iters=20, reseed_empty=reseed))
    assert set(engine.available()) == set(ENGINES)
    for backend in ENGINES:
        got = pkmeans(pts, init, m, KMeansParams(
            max_iters=20, reseed_empty=reseed, backend=backend),
            device="cpu")
        assert isinstance(got, PKMeansResult)
        assert got.iters.dtype == torch.int32, backend
        assert int(got.iters) == int(want.iters), backend
        assert bool(got.converged) == bool(want.converged), backend
        np.testing.assert_allclose(got.centroids.numpy(),
                                   np.asarray(want.centroids), rtol=RTOL,
                                   atol=ATOL, err_msg=backend)
        np.testing.assert_allclose(float(got.sse), float(want.sse),
                                   rtol=RTOL, err_msg=backend)
        # the reference's own empty-cluster case: without the reseed the
        # far seed stays put; with it, it moves into the data
        far = np.abs(got.centroids[2].numpy()).max()
        assert (far < 50.0) if reseed else (far == 500.0), backend


def test_pkmeans_leaves_the_seeds_alone_and_stops_at_max_iters():
    pts, init, _ = _data()
    seeds = torch.from_numpy(init.copy())
    got = pkmeans(pts, seeds, params=KMeansParams(max_iters=2),
                  device="cpu")
    assert int(got.iters) == 2 and not bool(got.converged)
    assert torch.equal(seeds, torch.from_numpy(init))
    with pytest.raises(NotImplementedError, match="later slice"):
        pkmeans_sharded(None, ("data",))


@pytest.mark.parametrize("backend", ENGINES)
def test_lloyd_step_matches_reference(backend):
    pts, init, mask = _data()
    step = jax.jit(jlloyd_step, static_argnames="backend")
    want_c, want_sse = step(jnp.asarray(pts), jnp.asarray(init),
                            jnp.asarray(mask))
    got_c, got_sse = lloyd_step(pts, init, mask, backend=backend,
                                device="cpu")
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got_sse), float(want_sse), rtol=RTOL)
    # the empty far cluster keeps its centroid
    assert torch.equal(got_c[2], torch.from_numpy(init[2]))
