"""The port's int8 error-feedback compression (``repro_torch.distributed
.compress``) against ``repro.distributed.compress``, in one process.

Each function gets the same numpy inputs as its JAX counterpart, compiled
(``jax.jit``) as the reference's S2 loop compiles it; everything must match
bit for bit (``ef_allreduce``, which needs a process group, is held against
the reference in ``tests/test_torch_distributed.py``).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compress as jcompress
from repro_torch.distributed import compress


def _stats(seed=0, m=6, k=5, d=3):
    rng = np.random.default_rng(seed)
    sums = (rng.normal(size=(m, k, d)) * 100).astype(np.float32)
    counts = rng.integers(0, 60, (m, k)).astype(np.float32)
    sums[1, 2] = 0.0                       # an empty cluster's row
    counts[3] = 0.0                        # an all-zero counts vector
    return {"sums": sums, "counts": counts}


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().dtype == np.asarray(want).dtype


@pytest.mark.parametrize("axis", [None, -1, (1, 2)])
def test_quantize_and_dequantize_match_reference(axis):
    x = _stats()["sums"]
    q, s = compress.quantize_int8(torch.from_numpy(x), axis=axis)
    jq, js = jax.jit(partial(jcompress.quantize_int8, axis=axis))(
        jnp.asarray(x))
    _eq(q, jq)
    _eq(s, js)
    _eq(compress.dequantize_int8(q, s),
        jax.jit(jcompress.dequantize_int8)(jq, js))


def test_zero_slices_round_trip_to_exact_zeros():
    x = np.zeros((3, 4), np.float32)
    x[1] = [1.0, -2.0, 3.0, 0.5]
    q, s = compress.quantize_int8(torch.from_numpy(x), axis=-1)
    out = compress.dequantize_int8(q, s)
    assert torch.equal(out[0], torch.zeros(4)) and torch.equal(
        out[2], torch.zeros(4))
    assert torch.equal(s[0], torch.ones(1)) and bool(torch.isfinite(out).all())
    q0, s0 = compress.quantize_int8(torch.zeros(5))
    assert float(s0) == 1.0 and not q0.any()


def test_compress_tree_carries_the_residual_as_the_reference():
    """Three calls, the residual fed back each time, per-row scales."""
    axes = {"sums": -1, "counts": -1}
    stats = [_stats(seed) for seed in range(3)]
    state = compress.init_ef({k: torch.from_numpy(v)
                              for k, v in stats[0].items()})
    jstate = jcompress.init_ef({k: jnp.asarray(v)
                                for k, v in stats[0].items()})
    jfn = jax.jit(partial(jcompress.compress_tree, axes=axes))
    for st in stats:
        payload, state = compress.compress_tree(
            {k: torch.from_numpy(v) for k, v in st.items()}, state,
            axes=axes)
        jpayload, jstate = jfn({k: jnp.asarray(v) for k, v in st.items()},
                               jstate)
        for leaf in ("sums", "counts"):
            _eq(payload[leaf][0], jpayload[leaf][0])
            _eq(payload[leaf][1], jpayload[leaf][1])
            _eq(state.residual[leaf], jstate.residual[leaf])
        assert compress.payload_bytes(payload) == jcompress.payload_bytes(
            jpayload)


def test_grads_round_trip_as_the_reference():
    """The gradient entry points: one scale a tensor, a nested tree."""
    rng = np.random.default_rng(3)
    grads = {"w": rng.normal(size=(4, 3)).astype(np.float32),
             "b": {"x": rng.normal(size=(3,)).astype(np.float32)}}
    tg = {"w": torch.from_numpy(grads["w"]),
          "b": {"x": torch.from_numpy(grads["b"]["x"])}}
    jg = jax.tree.map(jnp.asarray, grads)
    payload, state = compress.compress_grads(tg, compress.init_ef(tg))
    jpayload, jstate = jax.jit(jcompress.compress_grads)(
        jg, jcompress.init_ef(jg))
    _eq(payload["w"][0], jpayload["w"][0])
    _eq(payload["b"]["x"][1], jpayload["b"]["x"][1])
    _eq(state.residual["b"]["x"], jstate.residual["b"]["x"])
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        out = compress.decompress_grads(payload, dtype)
        want = jax.jit(partial(jcompress.decompress_grads, dtype=jdtype))(
            jpayload)
        assert out["w"].dtype == dtype
        np.testing.assert_array_equal(out["w"].float().numpy(),
                                      np.asarray(want["w"], np.float32))
    assert compress.payload_bytes(payload) == jcompress.payload_bytes(
        jpayload) == 12 + 3 + 4 * 2
