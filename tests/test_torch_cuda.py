"""The port's CUDA kernel on the card: against its plain version, and
bit-for-bit on a repeat launch.  Marked ``cuda``; skips without a card.
Run on a machine with one (no JAX needed, so without the JAX conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ipkmeans import IPKMeansConfig, ipkmeans
from repro_torch.core.kmeans import KMeansParams
from repro_torch.kernels import fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
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
