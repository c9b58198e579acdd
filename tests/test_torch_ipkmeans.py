"""The port's whole first slice against ``repro.core.ipkmeans.ipkmeans``.

Quickstart-sized data (n=2048, d=8, K=16, M=8), made from a seed with numpy,
goes to both packages; both take the config through
``convert.config_from_reference``, and the reference's fused engine runs its
Pallas kernel in interpret mode.  Subset ids, iteration counts and the tree
depth must match exactly; intermediate and final centroids, ASSEs and the
SSE within rtol 1e-4 (atol 1e-4), because per-cluster sums are f32 sums in
another order.
"""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kdtree as jkd
from repro.core.ipkmeans import IPKMeansConfig as JConfig
from repro.core.ipkmeans import ipkmeans as jipkmeans
from repro.core.kmeans import KMeansParams as JParams
from repro_torch import convert
from repro_torch.core.ipkmeans import (IPKMeansConfig, _partition_and_pack,
                                       ipkmeans)

RTOL, ATOL = 1e-4, 1e-4
SRC = Path(__file__).resolve().parents[1] / "src"


def _data(seed=0, n=2048, d=8, k=16):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-6, 6, size=(k, d))
    x = (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)))
    x = x.astype(np.float32)
    return x, x[rng.choice(n, k, replace=False)].copy()


def _as_dict(cfg: JConfig) -> dict:
    return {**dataclasses.asdict(cfg), "kmeans": cfg.kmeans._asdict()}


@pytest.mark.parametrize("reseed,leaf", [(True, None), (False, 64)])
def test_pipeline_matches_reference(reseed, leaf):
    x, init = _data()
    jcfg = JConfig(num_clusters=16, num_subsets=8, leaf_capacity=leaf,
                   kmeans=JParams(max_iters=50, backend="fused",
                                  reseed_empty=reseed))
    want = jipkmeans(jnp.asarray(x), jnp.asarray(init), jax.random.key(0),
                     jcfg)
    cfg = convert.config_from_reference(_as_dict(jcfg))
    assert cfg.kmeans.backend == "fused" and cfg.kmeans.reseed_empty == reseed
    px, pinit = convert.tensors_from_numpy(x, init, device="cpu")
    got = ipkmeans(px, pinit, cfg, device="cpu")

    part = _partition_and_pack(px, cfg)[0]
    jpart = jkd.partition_dataset(jnp.asarray(x), jax.random.key(0), 8,
                                  leaf_capacity=leaf)
    np.testing.assert_array_equal(part.subset_ids.numpy(),
                                  np.asarray(jpart.subset_ids))
    assert got.kd_depth == int(want.kd_depth)
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    np.testing.assert_allclose(got.intermediate.numpy(),
                               np.asarray(want.intermediate), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.asses.numpy(), np.asarray(want.asses),
                               rtol=RTOL)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


def test_eager_backend_matches_reference_jnp():
    x, init = _data(seed=1)
    jcfg = JConfig(num_clusters=16, num_subsets=8,
                   kmeans=JParams(max_iters=50, reseed_empty=True))
    want = jipkmeans(jnp.asarray(x), jnp.asarray(init), jax.random.key(0),
                     jcfg)
    cfg = convert.config_from_reference(_as_dict(jcfg))
    assert cfg.kmeans.backend == "eager"
    got = ipkmeans(x, init, cfg, device="cpu")
    np.testing.assert_array_equal(got.subset_iters.numpy(),
                                  np.asarray(want.subset_iters))
    np.testing.assert_allclose(float(got.sse), float(want.sse), rtol=RTOL)


@pytest.mark.parametrize("change,match", [
    (dict(partition="kd_random"), "partition"),
    (dict(partition="random"), "partition"),
    (dict(s1="histogram"), "histogram"),
    (dict(pack="sorted"), "pack"),
    (dict(pack="a2a"), "pack"),
    (dict(merge="hierarchical"), "hierarchical"),
    (dict(kmeans=JParams(backend="tuned")), "tuned"),
])
def test_unported_configs_raise(change, match):
    """Every configuration that earlier slices refused now runs: the
    reference's single-process S1 and S3 variants (held against the
    reference in ``tests/test_torch_s1.py``) and the ``tuned`` engine
    (``tests/test_torch_serve.py``); ``pack="a2a"`` warns and scatters, as
    the reference's single-process path does."""
    jcfg = dataclasses.replace(JConfig(num_clusters=4, num_subsets=2),
                               **change)
    cfg = convert.config_from_reference(_as_dict(jcfg))
    x = np.random.default_rng(0).normal(size=(32, 2)).astype(np.float32)
    assert match in repr(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ipkmeans(x, x[:4], cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)]
    assert len(warned) == (cfg.pack == "a2a")
    assert all(match in msg for msg in warned)
    assert tuple(got.centroids.shape) == (4, 2)
    assert bool(torch.isfinite(got.sse))
    assert int(got.subset_iters.min()) >= 1


def test_config_round_trip_keeps_every_field():
    jcfg = JConfig(num_clusters=5, num_subsets=3, s1="sort", leaf_capacity=7,
                   label_axis=1, reduce="int8ef",
                   kmeans=JParams(max_iters=9, tol=1e-3, backend="fused"))
    cfg = convert.config_from_reference(_as_dict(jcfg))
    assert cfg == IPKMeansConfig(
        num_clusters=5, num_subsets=3, s1="sort", leaf_capacity=7,
        label_axis=1, reduce="int8ef",
        kmeans=cfg.kmeans._replace(max_iters=9, tol=1e-3, backend="fused"))
    assert cfg.subset_capacity(1000) == jcfg.subset_capacity(1000)
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_reference({**_as_dict(jcfg), "bogus": 1})


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from repro_torch.core.kmeans import kmeans, kmeans_batched
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((32, 2), np.float32)
    cfg = IPKMeansConfig(num_clusters=4, num_subsets=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ipkmeans(x, x[:4], cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans(x, x[:4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans_batched(x[None], None, x[:4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensors_from_numpy(x, x[:4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ipkmeans(x, x[:4], cfg, device="cuda")


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core.ipkmeans, "
            "repro_torch.core.init, repro_torch.convert, "
            "repro_torch.kernels.engine, repro_torch.kernels.ops, "
            "repro_torch.kernels.assign, repro_torch.kernels.centroid_update, "
            "repro_torch.kernels.init, repro_torch.core.pkmeans, "
            "repro_torch.core.merge, repro_torch.core.kdtree, "
            "repro_torch.kernels.specs, repro_torch.core.io_model, "
            "repro_torch.core.serve, repro_torch.kernels.tuning, "
            "repro_torch.launch.serve_kmeans, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.distributed.runtime, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.attention, repro_torch.models.common, "
            "repro_torch.models.transformer, repro_torch.models.registry, "
            "repro_torch.launch.serve\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_import():
    """Every module of the port and chip_smoke.py, read as text: no import
    of jax or of the reference package anywhere, lazy ones included."""
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0].rstrip(",")
                assert root not in ("jax", "jaxlib", "repro"), (path, line)
