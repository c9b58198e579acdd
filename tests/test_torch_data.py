"""The paper's synthetic datasets (``repro_torch.data``) and the checkpoint
manager (``repro_torch.checkpoint``) against the reference's.

Fed JAX's own draws, the port's mixtures, paper datasets and initial
centroid groups must be the reference's arrays bit for bit.  Checkpoints
share one format on disk: each package restores what the other wrote,
bfloat16 included.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.checkpoint import manager as jmanager
from repro.data import synthetic as jsynthetic
from repro_torch import checkpoint as manager
from repro_torch.data import synthetic


@partial(jax.jit, static_argnums=(1, 2, 3))
def _draws(key, n, k, d):
    kc, kx, ka = jax.random.split(key, 3)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    v = jax.random.uniform(kx, (n, d), jnp.float32, lo, 1.0)
    return (jax.random.uniform(kc, (k, d)),
            jax.random.randint(ka, (n,), 0, k), lax.erf_inv(v))


def _jax_draws(key, n, k, d) -> synthetic.MixtureDraws:
    """The draws ``repro.data.synthetic.gaussian_mixture`` consumes, from
    the same keys: ``jax.random.normal``'s is its erfinv factor (it draws
    ``f32(sqrt 2) * erf_inv(v)``, v uniform on (-1, 1))."""
    return synthetic.MixtureDraws(*(torch.tensor(np.asarray(a))
                                    for a in _draws(key, n, k, d)))


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_mixture_matches_reference():
    """Points, centres and components, at dataset 1's arguments (the
    compiled programs are the paper test's: JAX compiles each shape once,
    which is most of this file's time)."""
    key = jax.random.key(0)
    want = jsynthetic.gaussian_mixture(key, 3000, 5, spread=5.0, sigma=2.0)
    got = synthetic.gaussian_mixture(3000, 5, 2, 5.0, 2.0,
                                     draws=_jax_draws(key, 3000, 5, 2),
                                     device="cpu")
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("which,n,k,seed", [("3000", 3000, 5, 0),
                                            ("15000", 15000, 4, 1)])
def test_paper_datasets_and_groups_match_reference(which, n, k, seed):
    jfn = getattr(jsynthetic, f"paper_dataset_{which}")
    fn = getattr(synthetic, f"paper_dataset_{which}")
    want = jfn()
    got = fn(draws=_jax_draws(jax.random.key(seed), n, k, 2), device="cpu")
    for a, b in zip(got, want):
        _same(a, b)
    groups = jsynthetic.initial_centroid_groups(want[0], k)
    blocks = [np.asarray(jax.random.uniform(jax.random.key(100 + g), (k, 2)))
              for g in range(5)]
    for a, b in zip(synthetic.initial_centroid_groups(got[0], k,
                                                      draws=blocks), groups):
        _same(a, b)


def test_generator_path_shapes_ranges_and_seeds():
    x, c = synthetic.paper_dataset_3000(device="cpu")
    again, _ = synthetic.paper_dataset_3000(device="cpu")
    other, _ = synthetic.paper_dataset_3000(seed=5, device="cpu")
    assert x.shape == (3000, 2) and c.shape == (5, 2)
    assert x.dtype == c.dtype == torch.float32
    assert torch.equal(x, again) and not torch.equal(x, other)
    assert float(c.min()) >= -5.0 and float(c.max()) < 5.0
    pts, cen, comp = synthetic.gaussian_mixture(
        500, 3, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    assert pts.shape == (500, 4) and cen.shape == (3, 4)
    assert comp.dtype == torch.int32 and set(comp.tolist()) <= {0, 1, 2}
    # each point lies within a few sigma of its own centre
    assert float(torch.max(torch.abs(pts - cen[comp.long()]))) < 6.0
    groups = synthetic.initial_centroid_groups(x, 5)
    lo, hi = x.min(0).values, x.max(0).values
    assert len(groups) == 5 and not torch.equal(groups[0], groups[1])
    for g in groups:
        assert g.shape == (5, 2) and bool(((g >= lo) & (g <= hi)).all())
    assert torch.equal(groups[3], synthetic.initial_centroid_groups(x, 5)[3])
    with pytest.raises(ValueError, match="draws"):
        synthetic.gaussian_mixture(10, 2, device="cpu")


def _trees(seed=0):
    """One tree in each package's leaves: a nested dict with unsorted keys,
    a list, a tuple, f32, int32 and bf16 leaves."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(3, 4)).astype(np.float32)
    i = rng.integers(-9, 9, (5,)).astype(np.int32)
    h = rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16)

    def make(conv):
        return {"zeta": [conv(f), conv(i)],
                "alpha": {"w": conv(h), "b": (conv(f[0]), conv(i[:2]))},
                "mid": conv(f * 2)}

    def tensor(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return make(jnp.asarray), make(tensor)


def _leaf_bits(tree):
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))
    out = []
    for a in leaves:
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            out.append((str(a.dtype), a.numpy().tobytes()))
        else:
            a = np.asarray(a)
            name = "torch.int16" if a.dtype.name == "bfloat16" else None
            a = a.view(np.int16) if name else a
            out.append((name or f"torch.{a.dtype}", a.tobytes()))
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_format_is_shared(tmp_path, writer):
    jtree, ttree = _trees()
    if writer == "reference":
        jmanager.save(tmp_path, 3, jtree)
        got = manager.restore(tmp_path, 3, ttree)
        assert list(got) == list(ttree)          # the dict keeps its order
        assert _leaf_bits(got) == _leaf_bits(ttree)
    else:
        manager.save(tmp_path, 3, ttree)
        got = jmanager.restore(tmp_path, 3, jtree)
        assert _leaf_bits(got) == _leaf_bits(jtree)
    meta = (tmp_path / "step_00000003" / "meta.json").read_text()
    assert "\"['alpha']/['b']/[0]\"" in meta and '"bfloat16"' in meta


def test_checkpoint_latest_gc_and_async(tmp_path):
    _, tree = _trees()
    assert manager.latest_step(tmp_path / "none") is None
    for step in (1, 2, 3, 4):
        manager.save(tmp_path, step, tree)
    (tmp_path / "step_00000009").mkdir()          # never committed
    assert manager.latest_step(tmp_path) == 4
    with pytest.raises(FileNotFoundError):
        manager.restore(tmp_path, 9, tree)
    manager.gc_old(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000003", "step_00000004", "step_00000009"]
    with pytest.raises(ValueError, match="leaves"):
        manager.restore(tmp_path, 4, {"one": tree["mid"]})

    ck = manager.AsyncCheckpointer(tmp_path / "async", keep=2)
    base = tree["mid"].clone()
    for step in (5, 6, 7):
        ck.save(step, tree)
        tree["mid"].add_(1.0)          # in place: the saved copy stays
    ck.wait()
    assert ck.last_saved == 7 and manager.latest_step(ck.directory) == 7
    step, got = manager.restore_latest(ck.directory, tree)
    assert step == 7
    assert torch.equal(got["mid"], base + 1.0 + 1.0)
    assert _leaf_bits(got["alpha"]) == _leaf_bits(tree["alpha"])
    assert len(list(ck.directory.glob("step_*"))) == 2
