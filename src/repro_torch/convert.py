"""Carry the reference's configuration and inputs across to the port.

K-means has no weights: the config and the seeds are what make the two
packages compute the same thing.  ``config_from_reference`` takes the
reference's ``IPKMeansConfig`` as plain data (``dataclasses.asdict``-style,
the nested ``KMeansParams`` as a dict), so this module needs nothing from the
reference package; ``tensors_from_numpy`` turns its numpy inputs into the
port's tensors.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.ipkmeans import IPKMeansConfig
from repro_torch.core.kmeans import KMeansParams
from repro_torch.device import as_f32, resolve_device

# reference engine name -> the port's name for the same role
BACKEND_NAMES = {"jnp": "eager", "pallas": "twopass"}


def params_from_reference(d: Mapping) -> KMeansParams:
    """The reference's ``KMeansParams`` as a dict -> the port's."""
    fields = {k: d[k] for k in KMeansParams._fields if k in d}
    unknown = set(d) - set(KMeansParams._fields)
    if unknown:
        raise ValueError(f"unknown KMeansParams fields: {sorted(unknown)}")
    if "backend" in fields:
        fields["backend"] = BACKEND_NAMES.get(fields["backend"],
                                              fields["backend"])
    return KMeansParams(**fields)


def config_from_reference(d: Mapping) -> IPKMeansConfig:
    """The reference's ``IPKMeansConfig`` as a dict -> the port's.  Every
    value of its single-process path carries across as it is (``partition``,
    ``s1``, ``pack``, ``merge``, ``reduce``); the engine names map through
    ``BACKEND_NAMES``."""
    names = {f.name for f in dataclasses.fields(IPKMeansConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown IPKMeansConfig fields: {sorted(unknown)}")
    fields = dict(d)
    if "kmeans" in fields:
        km = fields["kmeans"]
        if not isinstance(km, Mapping):
            raise TypeError("the nested KMeansParams must be given as a dict")
        fields["kmeans"] = params_from_reference(km)
    return IPKMeansConfig(**fields)


def tensors_from_numpy(points: np.ndarray, init_centroids: np.ndarray,
                       device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference inputs as numpy arrays -> float32 tensors on ``device``
    (default: CUDA, raising without a card)."""
    dev = resolve_device(device)
    return as_f32(np.asarray(points), dev), as_f32(np.asarray(init_centroids),
                                                   dev)
