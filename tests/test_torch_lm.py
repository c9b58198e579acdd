"""The port's LM serving path (``repro_torch.models``, ``configs``,
``launch.serve``) against the reference's, on the CPU.

The reference's weights come from ``registry.abstract_params`` filled with
numpy from a seed and boxed again (its own init draws for seconds here);
the port gets the same arrays through ``convert.model_from_reference``.  Each
reference function is compiled once a config, in a module-scoped fixture.

Tolerances (float32 on both sides, sums in another order):
- attention, norms, RoPE, SwiGLU: rtol 1e-5, atol 1e-6 (SwiGLU's sums of
  24 products atol 1e-5; RoPE at 3000 rad as its comment says);
- logits: rtol 1e-5 with atol 1e-5 of the largest logit (an entry near 0
  has no relative digits to keep);
- greedy tokens: exact;
- bfloat16 (the switched command-r config): logits within 2**-6 of the
  largest logit, greedy tokens the reference's choices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SMOKE_ARCHS as REF_SMOKE
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.configs import ARCHS, SMOKE_ARCHS, get_config
from repro_torch.launch import serve
from repro_torch.models import attention, common, registry, transformer

DENSE = ("minicpm-2b", "command-r-35b", "command-r-plus-104b",
         "deepseek-67b", "chameleon-34b")
NOT_PORTED = ("mixtral-8x7b", "deepseek-v3-671b", "recurrentgemma-9b",
              "xlstm-125m", "seamless-m4t-large-v2")
# the second served config turns on every switch the smoke configs leave off
SWITCHED = dict(qk_norm=True, tie_embeddings=False, attention="sliding",
                window=6)
B, PROMPT, NEW = 2, 8, 4


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=rtol, atol=atol)


def _configs(arch, switched):
    ref, port = REF_SMOKE[arch], SMOKE_ARCHS[arch]
    if switched:
        ref = dataclasses.replace(ref, **SWITCHED)
        port = dataclasses.replace(port, **SWITCHED)
    return ref, port


def _reference_values(cfg, seed=0):
    """(the reference's parameter values as nested numpy, their axes) for
    ``cfg``: each leaf of its abstract tree filled with normals from
    ``seed``, matrices at 1/sqrt(d_model), norm weights near their init."""
    values, axes = ref_common.unbox(ref_registry.abstract_params(cfg))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if leaf.ndim >= 2 and not (name.endswith("norm")
                                   or name.startswith("norm")):
            a = rng.standard_normal(leaf.shape) / np.sqrt(cfg.d_model)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
            if cfg.norm == "layernorm" and name in ("norm1", "norm2",
                                                    "final_norm"):
                a += 1.0
        return a.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, values), axes


def _reference_greedy(cfg, forward, step, params, prompt):
    """The reference's ``launch.serve.greedy_generate``, step for step, on
    its ``forward`` and ``decode_step`` compiled once (its own function
    compiles three programs on every call): the prompt's caches from
    single-token decode steps, the first token from the prefill's last
    logits, then ``NEW`` decode steps."""
    b, s0 = prompt.shape
    caches = ref_registry.init_decode_caches(cfg, b, s0 + NEW)
    for t in range(s0):
        _, caches = step(params, caches, prompt[:, t:t + 1], jnp.int32(t))
    logits = forward(params, prompt)[:, -1]
    out = [prompt]
    for t in range(s0, s0 + NEW):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(nxt)
        step_logits, caches = step(params, caches, nxt, jnp.int32(t))
        logits = step_logits[:, -1]
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.fixture(scope="module", params=[("minicpm-2b", False),
                                        ("command-r-35b", True)],
                ids=["minicpm-2b", "command-r-35b-switched"])
def served(request):
    """One config: the reference's forward logits and greedy tokens, each
    function compiled once, and the port's model from the same weights.
    The switched command-r also gives its weights in bfloat16, the
    published dtype, and the reference's forward there."""
    arch, switched = request.param
    ref_cfg, cfg = _configs(arch, switched)
    values, axes = _reference_values(ref_cfg)
    params = ref_common.boxed_like(jax.tree.map(jnp.asarray, values), axes)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    forward = jax.jit(lambda p, t: ref_tf.forward(p, t, ref_cfg)[0])
    step = jax.jit(ref_registry.decode_step_fn(ref_cfg))
    out = dict(
        cfg=cfg, prompt=prompt,
        model=convert.model_from_reference(cfg, values, device="cpu"),
        logits=np.asarray(forward(params, jnp.asarray(prompt))),
        tokens=_reference_greedy(ref_cfg, forward, step, params,
                                 jnp.asarray(prompt)))
    if switched:
        ref16 = dataclasses.replace(ref_cfg, dtype="bfloat16")
        values, axes = _reference_values(ref16)
        params16 = ref_common.boxed_like(jax.tree.map(jnp.asarray, values),
                                         axes)
        forward16 = jax.jit(lambda p, t: ref_tf.forward(p, t, ref16)[0])
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        out["bf16"] = dict(
            cfg=cfg16,
            model=convert.model_from_reference(cfg16, values, device="cpu"),
            forward=lambda t: np.asarray(forward16(
                params16, jnp.asarray(t)).astype(jnp.float32)))
    return out


def test_attention_matches_reference():
    rng = np.random.default_rng(0)
    b, s, h, hk, dq, dv, w = 2, 37, 4, 2, 8, 6, 8
    q = rng.standard_normal((b, s, h, dq)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, dq)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, dv)).astype(np.float32)
    # a ring of W slots after S > W positions: it has wrapped
    slots = np.arange(s) % w
    ring_k = np.zeros((b, w, hk, dq), np.float32)
    ring_v = np.zeros((b, w, hk, dv), np.float32)
    ring_pos = np.full((b, w), -1, np.int32)
    for t in range(s):
        ring_k[:, slots[t]], ring_v[:, slots[t]] = k[:, t], v[:, t]
        ring_pos[:, slots[t]] = t

    @jax.jit
    def reference(q, k, v, ring_k, ring_v, ring_pos):
        return dict(
            dense=[ref_attn.dense_attention(q, k, v, window=win)
                   for win in (None, 10, w)],
            # uneven chunks: neither divides S, and the grids are not
            # aligned
            chunked=[ref_attn.chunked_attention(q, k, v, window=win,
                                                q_chunk=8, kv_chunk=12)
                     for win in (None, 10)],
            decode=ref_attn.decode_attention(q[:, -1:], ring_k, ring_v,
                                             ring_pos, s - 1, window=w))

    want = reference(q, k, v, ring_k, ring_v, ring_pos)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for i, window in enumerate((None, 10)):
        _close(attention.dense_attention(tq, tk, tv, window=window),
               want["dense"][i])
        got = attention.chunked_attention(tq, tk, tv, window=window,
                                          q_chunk=8, kv_chunk=12)
        _close(got, want["chunked"][i])
        _close(attention.attention(tq, tk, tv, window=window, q_chunk=8,
                                   kv_chunk=12, dense_below=16),
               want["chunked"][i])
    rk, rv, rp = map(torch.from_numpy, (ring_k, ring_v, ring_pos))
    for pos in (s - 1, torch.full((b,), s - 1)):
        _close(attention.decode_attention(tq[:, -1:], rk, rv, rp, pos,
                                          window=w), want["decode"])
    # the wrapped ring holds exactly the window's positions
    _close(torch.from_numpy(np.array(want["decode"])),
           want["dense"][2][:, -1:])


def test_norms_rope_swiglu_match_reference():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 16)) + 1).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    # interleaved pairs at theta = 8e6, positions into the thousands
    xr = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(3000, 3006)]).astype(np.int32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) for _ in "gu")
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    thetas = (10_000.0, 8_000_000.0)

    @jax.jit
    def reference(x, w, xr, pos, wg, wu, wd):
        return dict(
            rms=ref_common.apply_norm(x, w, "rmsnorm"),
            ln=ref_common.apply_norm(x, w, "layernorm"),
            # bfloat16 in and out, computed in float32
            rms_bf16=ref_common.rmsnorm(x.astype(jnp.bfloat16), w),
            freqs=[ref_common.rope_freqs(16, th) for th in thetas],
            rope=[ref_common.apply_rope(xr, pos, th) for th in thetas],
            swiglu=ref_common.swiglu(x, wg, wu, wd))

    want = reference(x, w, xr, pos, wg, wu, wd)
    tx, tw, txr, tpos = map(torch.from_numpy, (x, w, xr, pos))
    _close(common.rmsnorm(tx, tw), want["rms"])
    _close(common.apply_norm(tx, tw, "rmsnorm"), want["rms"])
    _close(common.layernorm(tx, tw), want["ln"])
    _close(common.apply_norm(tx, tw, "layernorm"), want["ln"])
    got = common.rmsnorm(tx.bfloat16(), tw)
    assert got.dtype == torch.bfloat16
    _close(got, want["rms_bf16"].astype(jnp.float32), rtol=2 ** -7, atol=0)
    for i, theta in enumerate(thetas):
        _close(common.rope_freqs(16, theta), want["freqs"][i])
        got = common.apply_rope(txr, tpos, theta)
        _close(got[0], want["rope"][i][0])
        # at 3000 rad the reference's compiled cos and sin reduce the f32
        # angle A to within about A * 2**-24, times |x|
        _close(got[1], want["rope"][i][1],
               atol=3006 * 2.0 ** -24 * np.abs(xr).max())
    # the port's rotation against float64 at the same float32 angles; a
    # rotation of the two halves would fail it: pair (0, 1) turns by the
    # angle pos * 1 and mixes with no other entry
    ang = pos[..., None].astype(np.float32).astype(np.float64)
    _close(common.apply_rope(txr, tpos)[..., 0],
           xr[..., 0] * np.cos(ang) - xr[..., 1] * np.sin(ang))
    _close(common.swiglu(tx, *map(torch.from_numpy, (wg, wu, wd))),
           want["swiglu"], rtol=1e-5, atol=1e-5)


def test_forward_and_greedy_generate_match_reference(served):
    cfg, model = served["cfg"], served["model"]
    prompt = torch.from_numpy(served["prompt"])
    logits, _, _ = transformer.forward(model, prompt, cfg)
    want = served["logits"]
    _close(logits, want, atol=1e-5 * np.abs(want).max())
    tokens, seen = serve.greedy_generate(cfg, model, prompt, max_new=NEW,
                                         return_logits=True)
    np.testing.assert_array_equal(tokens.numpy(), served["tokens"])
    # the decode steps against one forward over prompt + generated tokens
    full, _, _ = transformer.forward(model, tokens, cfg)
    _close(seen, full[:, PROMPT - 1:].float(), atol=1e-5 * np.abs(want).max())
    step = serve.make_prefill_step(cfg)
    _close(step(model, {"tokens": prompt}), want[:, -1],
           atol=1e-5 * np.abs(want).max())
    if "bf16" not in served:
        return
    # bfloat16, the published dtype, with its cast points (the embedding's
    # dtype, the residual and logit scales, model-dtype logits before the
    # argmax): the port's greedy tokens are the ones the reference's forward
    # over them picks at every generated position (so its greedy run picks
    # them too), and the port's forward over them is within 2**-6 of the
    # largest logit of the reference's (about 4 bfloat16 ulps: both round
    # each product and op to bfloat16, in their own places)
    run = served["bf16"]
    tokens = serve.greedy_generate(run["cfg"], run["model"], prompt,
                                   max_new=NEW)
    want = run["forward"](tokens.numpy())
    np.testing.assert_array_equal(tokens[:, PROMPT:].numpy(),
                                  want[:, PROMPT - 1:-1].argmax(-1))
    logits, _, _ = transformer.forward(run["model"], tokens, run["cfg"])
    assert logits.dtype == torch.bfloat16
    _close(logits, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())


def _reference_leaves(cfg):
    """{port parameter name: (shape, dtype name, axes)} from the
    reference's abstract tree, each scanned group unstacked."""
    values, axes = ref_common.unbox(ref_registry.abstract_params(cfg))
    counts = [c for _, c in ref_tf.layer_groups(cfg)]
    flat_v = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_a = jax.tree.leaves(axes, is_leaf=lambda a: isinstance(a, tuple))
    out = {}
    for (path, leaf), ax in zip(flat_v, flat_a):
        keys = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        dtype = str(leaf.dtype)
        if keys[0] != "groups":
            out[".".join(keys)] = (tuple(leaf.shape), dtype, ax)
            continue
        gi, rest = int(keys[1]), ".".join(keys[2:])
        if counts[gi] == 1:
            out[f"groups.{gi}.0.{rest}"] = (tuple(leaf.shape), dtype, ax)
            continue
        assert ax[0] == "layers" and leaf.shape[0] == counts[gi]
        for li in range(counts[gi]):
            out[f"groups.{gi}.{li}.{rest}"] = (tuple(leaf.shape[1:]), dtype,
                                               ax[1:])
    return out


def test_param_axes_shapes_and_counts_match_reference():
    # the smoke configs between them have every parameter: QK-norm
    # (chameleon), an untied head (deepseek), LayerNorm without norm2
    # (command-r's parallel block)
    for arch in DENSE:
        model = registry.init_params(SMOKE_ARCHS[arch], device="meta")
        axes = common.param_axes(model)
        got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."),
                   axes[n]) for n, p in model.named_parameters()}
        assert got == _reference_leaves(REF_SMOKE[arch]), arch
        # the published shapes, counted without allocating
        assert registry.count_params(ARCHS[arch]) == \
            ref_registry.count_params_abstract(REF_ARCHS[arch]), arch
        assert ARCHS[arch].param_count() == registry.count_params(ARCHS[arch])
    assert registry.count_params(ARCHS["minicpm-2b"]) == 2_724_880_896
    # bfloat16 configs keep their norm weights in float32
    model = registry.init_params(ARCHS["chameleon-34b"], device="meta")
    dtypes = {n.split(".")[-1]: p.dtype for n, p in model.named_parameters()}
    assert dtypes["wq"] == dtypes["embed"] == torch.bfloat16
    assert dtypes["q_norm"] == dtypes["norm1"] == torch.float32

    # weights cross leaf for leaf, dtype kept: a missing, extra or
    # mis-shaped leaf raises
    cfg = SMOKE_ARCHS["deepseek-67b"]
    values, _ = _reference_values(REF_SMOKE["deepseek-67b"])
    values["embed"] = values["embed"].astype(jnp.bfloat16)
    model = convert.model_from_reference(cfg, values, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert torch.equal(model.embed.view(torch.int16), torch.from_numpy(
        values["embed"].view(np.int16)))
    np.testing.assert_array_equal(
        model.groups[0][2].attn.wk.numpy(), values["groups"][0]["attn"]["wk"][2])
    bad = [dict(values, extra=values["final_norm"]),
           {k: v for k, v in values.items() if k != "lm_head"},
           dict(values, final_norm=values["final_norm"][:-1])]
    for tree in bad:
        with pytest.raises(ValueError):
            convert.model_from_reference(cfg, tree, device="cpu")


def test_entry_points(monkeypatch, capsys):
    cfg = SMOKE_ARCHS["minicpm-2b"]
    out = serve.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "6", "--max-new", "3"])
    assert out.shape == (2, 9) and "served batch=2" in capsys.readouterr().out
    gen = torch.Generator().manual_seed(0)
    model = registry.init_params(cfg, gen, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    # a repeat gives the same tokens; the CPU model's parameters are float32
    assert torch.equal(serve.greedy_generate(cfg, model, prompt, max_new=3),
                       serve.greedy_generate(cfg, model, prompt, max_new=3))
    with pytest.raises(ValueError, match="Generator"):
        registry.init_params(cfg, device="cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: registry.init_params(cfg, gen),
                 lambda: registry.init_decode_caches(cfg, 2, 8),
                 lambda: convert.model_from_reference(cfg, {}),
                 lambda: serve.main(["--arch", "minicpm-2b", "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

    for arch in NOT_PORTED:
        for calls in (lambda c: registry.init_params(c, device="meta"),
                      registry.count_params, serve.make_prefill_step,
                      registry.decode_step_fn,
                      lambda c: registry.init_decode_caches(c, 1, 4, "cpu")):
            with pytest.raises(NotImplementedError, match="queue 1 item 3"):
                calls(get_config(arch, smoke=True))
