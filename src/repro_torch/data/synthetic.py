"""Synthetic datasets of the paper's experiments (Section 3), the
counterpart of ``repro.data.synthetic``.

Dataset 1: 3000 Gaussian 2-D points, 5 clusters (Fig 4).
Dataset 2: 15000 points, 4 clusters.
Initial-centroid groups: 5 groups, fixed per experiment.

``jax.random`` streams cannot be reproduced in torch, so every function
takes its random draws as inputs, or draws them from a ``torch.Generator``.
Given JAX's draws, the points, centres and groups are the reference's bit
for bit: the reference's compiled programs fuse each scale-and-shift into
one rounding (``ref.fma_f32``), and so does this module.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import fma_f32


class MixtureDraws(NamedTuple):
    """The draws of :func:`gaussian_mixture`.

    ``erfinv`` holds ``erfinv(v)`` for ``v`` uniform on (-1, 1): a standard
    normal over sqrt(2), the form in which ``jax.random.normal`` draws one
    (it returns ``f32(sqrt 2) * erfinv(v)``).  The reference's compiled
    program folds sqrt(2) into ``sigma`` and fuses the shift by the centre,
    so a point is ``fma(erfinv, f32(sqrt 2) * sigma, centre)``, one
    rounding; from the rounded standard normals the bits would differ in
    about a fifth of the coordinates, by up to 2 ulps.
    """
    uniforms: torch.Tensor      # (k, d) f32 in [0, 1): the centres
    components: torch.Tensor    # (n,) integers in [0, k)
    erfinv: torch.Tensor        # (n, d) f32: standard normals / sqrt(2)


def _mixture_draws(n: int, k: int, d: int, generator: torch.Generator,
                  device=None) -> MixtureDraws:
    """Fresh draws for :func:`gaussian_mixture` from ``generator`` (on
    ``generator.device``), moved to ``device``."""
    gdev = generator.device
    u = torch.rand((k, d), generator=generator, device=gdev)
    comp = torch.randint(0, k, (n,), generator=generator, device=gdev,
                         dtype=torch.int32)
    e = torch.randn((n, d), generator=generator, device=gdev) * math.sqrt(0.5)
    dev = resolve_device(device)
    return MixtureDraws(u.to(dev), comp.to(dev), e.to(dev))


def _tensor(a, dtype=None, device=None) -> torch.Tensor:
    """An input as a tensor (a numpy or JAX array is copied: it may be
    read-only)."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def _uniform(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jax.random.uniform``'s affine map of ``u`` in [0, 1) onto [lo,
    hi): ``max(lo, u * (hi - lo) + lo)``, the width in float32 and the
    product fused into the sum."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=u.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, fma_f32(u, hi - lo, lo.expand_as(u)))


def gaussian_mixture(n: int, k: int, d: int = 2, spread: float = 6.0,
                     sigma: float = 1.0, *, draws: MixtureDraws | None = None,
                     generator: torch.Generator | None = None, device=None):
    """``n`` points from ``k`` isotropic Gaussians of deviation ``sigma``,
    their centres uniform on [-spread, spread) -> ``(points (n,d) f32,
    centres (k,d) f32, component (n,) int32)``.

    The draws come from ``draws`` (:class:`MixtureDraws`; the reference's
    are ``jax.random.uniform(kc, (k, d))``, ``jax.random.randint(ka, (n,),
    0, k)`` and the ``erfinv`` factor of ``jax.random.normal(kx, (n, d))``,
    for ``kc, kx, ka = jax.random.split(key, 3)``) or from ``generator``.
    Runs on ``device`` (default: CUDA, raising without a card).
    """
    dev = resolve_device(device)
    if draws is None:
        if generator is None:
            raise ValueError("gaussian_mixture needs its draws, or a "
                             "torch.Generator to draw them from")
        draws = _mixture_draws(n, k, d, generator, dev)
    u = _tensor(draws.uniforms, torch.float32, dev)
    comp = _tensor(draws.components, torch.int32, dev)
    e = _tensor(draws.erfinv, torch.float32, dev)
    for name, t, shape in (("uniforms", u, (k, d)), ("components", comp,
                                                     (n,)),
                           ("erfinv", e, (n, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"draws.{name} of shape {tuple(t.shape)}, "
                             f"expected {shape}")
    spread = torch.tensor(spread, dtype=torch.float32)
    centers = _uniform(u, -spread, spread)
    scale = (torch.tensor(math.sqrt(2.0), dtype=torch.float32)
             * torch.tensor(sigma, dtype=torch.float32)).to(dev)
    points = fma_f32(e, scale, centers[comp.long()])
    return points, centers, comp


def _paper_dataset(n: int, k: int, seed: int, draws, generator, device):
    if draws is None and generator is None:
        generator = torch.Generator().manual_seed(seed)
    pts, centers, _ = gaussian_mixture(n, k, spread=5.0, sigma=2.0,
                                       draws=draws, generator=generator,
                                       device=device)
    return pts, centers


def paper_dataset_3000(seed: int = 0, *, draws: MixtureDraws | None = None,
                       generator: torch.Generator | None = None,
                       device=None):
    """Paper dataset 1: 3000 2-D Gaussian points, 5 clusters, centres on
    [-5, 5), sigma 2 -> ``(points, centres)``.

    The overlap matches the paper's Figure 4 (visibly touching blobs); with
    well-separated blobs Lloyd converges in under 15 iterations, and
    PKMeans's few jobs can beat IPKMeans's preprocessing, as the paper
    observes for its experiments 2-3.  Draws from ``draws``, else
    ``generator``, else a CPU generator seeded with ``seed`` (the reference
    draws from ``jax.random.key(seed)``)."""
    return _paper_dataset(3000, 5, seed, draws, generator, device)


def paper_dataset_15000(seed: int = 1, *, draws: MixtureDraws | None = None,
                        generator: torch.Generator | None = None,
                        device=None):
    """Paper dataset 2: 15000 2-D Gaussian points, 4 clusters; draws as in
    :func:`paper_dataset_3000`."""
    return _paper_dataset(15000, 4, seed, draws, generator, device)


def initial_centroid_groups(points, k: int, groups: int = 5, seed: int = 100,
                            *, draws=None,
                            generator: torch.Generator | None = None
                            ) -> list[torch.Tensor]:
    """The paper's "5 different groups of initial centroids": uniform over
    the data's bounding box (Figure 4 shows '+' marks spread over the
    plane, not on data points) -> ``groups`` tensors ``(k, d)`` f32 on the
    points' device.

    ``draws``: ``groups`` uniform blocks ``(k, d)`` in [0, 1) (the
    reference's are ``jax.random.uniform(jax.random.key(seed + g), (k,
    d))``); without them they come from ``generator``, else from a CPU
    generator seeded with ``seed``."""
    points = _tensor(points)
    lo = torch.amin(points, dim=0).float()
    hi = torch.amax(points, dim=0).float()
    d = points.shape[1]
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        draws = [torch.rand((k, d), generator=generator,
                            device=generator.device) for _ in range(groups)]
    if len(draws) != groups:
        raise ValueError(f"{len(draws)} uniform blocks for {groups} groups")
    out = []
    for u in draws:
        u = _tensor(u, torch.float32, points.device)
        if tuple(u.shape) != (k, d):
            raise ValueError(f"a uniform block of shape {tuple(u.shape)}, "
                             f"expected {(k, d)}")
        out.append(_uniform(u, lo, hi))
    return out
