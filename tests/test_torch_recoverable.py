"""``ipkmeans_recoverable`` against the reference's and against the port's
own ``ipkmeans`` (the runtime and the per-lane-seed solves it drives:
``tests/test_torch_recover.py``).

It runs on the reference test's input (``tests/test_fault_tolerance.py``),
the reference once for the module; the port must give its log and work, its
iteration counts exactly and its centroids and SSE within rtol 1e-4
(per-cluster sums are f32 sums in another order), and ``ipkmeans``'s result
bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans_recoverable as jrecoverable
from repro.data.synthetic import gaussian_mixture as jmixture
from repro_torch.core import (IPKMeansConfig, KMeansParams, ipkmeans,
                              ipkmeans_recoverable)

RTOL = 1e-4

CRASH = {3: 3}
ROUNDS = dict(num_workers=4, iters_per_round=2, snapshot_every=2)


@pytest.fixture(scope="module")
def case():
    """The reference test's input and the reference's crash run."""
    pts, _, _ = jmixture(jax.random.PRNGKey(0), 1024, 5, d=2, spread=8.0,
                         sigma=0.8)
    want = jrecoverable(pts, pts[:5], jax.random.PRNGKey(2),
                        JConfig(num_clusters=5, num_subsets=8),
                        fail_at=CRASH, **ROUNDS)
    x = np.array(pts)
    return x, x[:5].copy(), want


def _cfg(backend):
    return IPKMeansConfig(num_clusters=5, num_subsets=8,
                          kmeans=KMeansParams(backend=backend))


def _work_by_stack(work):
    return [sum(1 for *_, s in work if s == st) for st in range(4)]


@pytest.mark.parametrize("backend", ["eager", "batched"])
def test_recoverable_matches_reference(case, backend):
    x, init, (want, wlog, wwork) = case
    got, log, work = ipkmeans_recoverable(x, init, _cfg(backend),
                                          fail_at=CRASH, device="cpu",
                                          **ROUNDS)
    assert log == wlog and work == wwork
    rec = [e for e in log if e[0] == "recover"][0]
    assert rec[2] == (3,)
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    assert got.kd_depth == int(want.kd_depth)
    for a, b in ((got.centroids, want.centroids),
                 (got.intermediate, want.intermediate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=RTOL)
    np.testing.assert_allclose(got.asses.numpy(), np.asarray(want.asses),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


@pytest.mark.parametrize("backend", ["eager", "batched"])
def test_recoverable_is_ipkmeans_bit_for_bit(case, backend):
    """Crash-free and with a crash: ``ipkmeans``'s result bit for bit, and
    only the crashed worker's stack advanced more often than in the
    crash-free run."""
    x, init, _ = case
    cfg = _cfg(backend)
    base = ipkmeans(x, init, cfg, device="cpu")
    free, _, work_free = ipkmeans_recoverable(x, init, cfg, device="cpu",
                                              **ROUNDS)
    crash, _, work = ipkmeans_recoverable(x, init, cfg, fail_at=CRASH,
                                          device="cpu", **ROUNDS)
    for res in (free, crash):
        for field in ("centroids", "sse", "intermediate", "asses",
                      "subset_iters"):
            assert torch.equal(getattr(res, field), getattr(base, field))
    a, b = _work_by_stack(work), _work_by_stack(work_free)
    assert a[3] > b[3] and a[:3] == b[:3]


def test_recoverable_carries_float32_between_rounds(case):
    """bfloat16 seeds: the rounds run on a float32 carry, as in the
    reference, so the intermediate centroids are the f32-seeded run's,
    rounded to bfloat16 once at the end."""
    x, init, _ = case
    seeds = torch.as_tensor(init).to(torch.bfloat16)
    got, _, _ = ipkmeans_recoverable(x, seeds, _cfg("batched"), device="cpu",
                                     **ROUNDS)
    base = ipkmeans(x, seeds.float(), _cfg("batched"), device="cpu")
    assert got.intermediate.dtype == torch.bfloat16
    assert torch.equal(got.intermediate, base.intermediate.to(torch.bfloat16))
    assert torch.equal(got.subset_iters, base.subset_iters)


def test_recoverable_checks_its_arguments(case, monkeypatch):
    x, init, _ = case
    with pytest.raises(ValueError, match="not divisible"):
        ipkmeans_recoverable(x, init, _cfg("eager"), num_workers=3,
                             device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ipkmeans_recoverable(x, init, _cfg("eager"), num_workers=4)
