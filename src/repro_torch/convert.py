"""Carry the reference's configuration, inputs and weights across to the port.

K-means has no weights: the config and the seeds are what make the two
packages compute the same thing.  ``config_from_reference`` takes the
reference's ``IPKMeansConfig`` as plain data (``dataclasses.asdict``-style,
the nested ``KMeansParams`` as a dict), so this module needs nothing from the
reference package; ``tensors_from_numpy`` turns its numpy inputs into the
port's tensors, in their own dtype (float32 or bfloat16).  The LM has
weights: ``model_from_reference`` takes the reference's parameter values as
a nested tree of numpy arrays and builds the port's model from them.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.ipkmeans import IPKMeansConfig
from repro_torch.core.kmeans import KMeansParams
from repro_torch.device import (FLOAT_DTYPES, _from_numpy, as_float,
                                resolve_device)

if TYPE_CHECKING:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import Transformer

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
    """Reference inputs as numpy arrays -> tensors of the same dtype, float32
    or bfloat16 (a bfloat16 array, ``ml_dtypes.bfloat16`` as ``np.asarray``
    of a JAX array gives it, crosses bit for bit), on ``device`` (default:
    CUDA, raising without a card).  Any other float dtype raises
    ``TypeError``."""
    dev = resolve_device(device)
    return as_float(np.asarray(points), dev), as_float(
        np.asarray(init_centroids), dev)


def model_from_reference(cfg: ModelConfig, values: Mapping,
                         device=None) -> Transformer:
    """The reference's LM parameter values -> the port's model on ``device``
    (default: CUDA, raising without a card).

    ``values`` is the values half of the reference's ``unbox``: nested dicts
    and lists of numpy arrays (``np.asarray`` of each JAX leaf).  A layer
    group's leaves carry the scanned ``layers`` axis first, which is
    unstacked into one module a layer (a group of one layer has none).
    Each leaf keeps its dtype, float32 or bfloat16 (bit for bit); a leaf
    the model lacks, a parameter with no leaf, a mis-shaped leaf or any
    other dtype raises."""
    # imported here: the k-means bridges above need none of the LM stack
    from repro_torch.models import transformer

    dev = resolve_device(device)
    model = transformer.init_params(cfg, device="meta")
    want = dict(model.named_parameters())
    counts = [count for _, count in transformer.layer_groups(cfg)]
    state = {}

    def put(name, leaf):
        if name not in want:
            raise ValueError(f"leaf {name!r} has no parameter in the port's "
                             f"{cfg.name} model")
        t = _from_numpy(leaf)
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"leaf {name!r}: float32 or bfloat16 expected, "
                            f"got {t.dtype}")
        if tuple(t.shape) != tuple(want[name].shape):
            raise ValueError(f"leaf {name!r} has shape {tuple(t.shape)}, the "
                             f"port's parameter {tuple(want[name].shape)}")
        state[name] = t.to(dev)

    def leaves(prefix, node):
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            yield prefix, node
            return
        for key, sub in items:
            yield from leaves(f"{prefix}.{key}" if prefix else str(key), sub)

    for name, leaf in leaves("", {k: v for k, v in values.items()
                                  if k != "groups"}):
        put(name, leaf)
    groups = values.get("groups", [])
    if len(groups) != len(counts):
        raise ValueError(f"{len(groups)} layer groups given, the port's "
                         f"{cfg.name} model has {len(counts)}")
    for gi, (group, count) in enumerate(zip(groups, counts)):
        for path, leaf in leaves("", group):
            leaf = np.asarray(leaf)
            if count == 1:
                put(f"groups.{gi}.0.{path}", leaf)
                continue
            if leaf.ndim == 0 or leaf.shape[0] != count:
                raise ValueError(f"group {gi} leaf {path!r} has shape "
                                 f"{leaf.shape}: its first axis should be "
                                 f"the group's {count} layers")
            for li in range(count):
                put(f"groups.{gi}.{li}.{path}", leaf[li])
    missing = sorted(set(want) - set(state))
    if missing:
        raise ValueError(f"no leaf for the port's parameters {missing}")
    model.load_state_dict(state, strict=True, assign=True)
    return model
