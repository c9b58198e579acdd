"""Config-driven decoder LM: the dense layer kind of ``repro.models.transformer``.

A model is a sequence of homogeneous *layer groups* (:func:`layer_groups`,
the reference's logic whole).  The port builds the ``dense`` kind: GQA
attention (full or sliding window, optional QK-norm, interleaved RoPE) and
a SwiGLU FFN, sequential or as command-r's parallel block, with minicpm's
embed, residual and logit scales, tied or untied head.  Every other kind
raises ``NotImplementedError`` (ROADMAP queue 1 item 3).

The reference stacks a group's parameters on a leading ``layers`` axis and
runs them under ``lax.scan``, with ``jax.checkpoint`` (remat) in training and
``shard`` constraints for its meshes.  Serving eagerly on one device needs
none of that: here a group is an ``nn.ModuleList`` of one module a layer,
run by a Python loop; remat only matters to a backward pass, and ``shard``
does nothing on one device.  ``convert.model_from_reference`` unstacks the
reference's weights.

Decode caches keep the reference's layout: one dict a group, ``{'k', 'v'}``
of (L, B, T, Hk, Dh) and ``'kv_pos'`` of (L, B, T) int32 (no leading L for a
group of one layer).  A sliding-window layer keeps a ring of
``min(window, max_len)`` slots, written at ``pos % T``.  The port writes a
decode step's keys and values into the caches in place and returns the same
cache objects, where the reference returns new arrays.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (apply_norm, apply_rope, model_dtype,
                                       new_param, norm_param, rmsnorm,
                                       swiglu)

NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1 item 3): the port "
              "builds the dense decoder kind only")

# ---------------------------------------------------------------- groups


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, num_layers_in_group), ...] in execution order."""
    if cfg.xlstm is not None:
        return [("slstm" if i in cfg.xlstm.slstm_layers else "mlstm", 1)
                for i in range(cfg.num_layers)]
    if cfg.recurrent is not None:
        pat = cfg.recurrent.pattern
        full, rem = divmod(cfg.num_layers, len(pat))
        groups = [("griffin", full)] if full else []
        for i in range(rem):                       # tail layers, unscanned
            groups.append((f"griffin_tail_{pat[i]}", 1))
        return groups
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        kind = "mla_moe" if cfg.mla is not None else "moe"
        dense_kind = "mla_dense" if cfg.mla is not None else "dense"
        return [(dense_kind, cfg.moe.first_dense_layers),
                (kind, cfg.num_layers - cfg.moe.first_dense_layers)]
    if cfg.moe is not None:
        return [("moe", cfg.num_layers)]
    if cfg.mla is not None:
        return [("mla_dense", cfg.num_layers)]
    return [("dense", cfg.num_layers)]


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is of a
    kind the port builds."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder model "
                                  f"{NOT_PORTED}")
    for kind, _ in layer_groups(cfg):
        if kind != "dense":
            raise NotImplementedError(f"{cfg.name}: layer kind {kind!r} "
                                      f"{NOT_PORTED}")


# ---------------------------------------------------------------- modules


class Attention(nn.Module):
    """GQA projections: wq (d, H, Dh), wk/wv (d, Hk, Dh), wo (H, Dh, d);
    float32 ``q_norm``/``k_norm`` (Dh,) with QK-norm."""
    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "q_norm": ("head_dim",), "k_norm": ("head_dim",)}

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim_
        dt = model_dtype(cfg)
        self.wq = new_param((d, h, dh), dt, device, generator)
        self.wk = new_param((d, hk, dh), dt, device, generator)
        self.wv = new_param((d, hk, dh), dt, device, generator)
        self.wo = new_param((h, dh, d), dt, device, generator)
        if cfg.qk_norm:
            self.q_norm = norm_param(dh, "rmsnorm", device)
            self.k_norm = norm_param(dh, "rmsnorm", device)


class MLP(nn.Module):
    """SwiGLU weights: w_gate, w_up (d, f), w_down (f, d)."""
    AXES = {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
            "w_down": ("ff", "embed")}

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = model_dtype(cfg)
        self.w_gate = new_param((d, f), dt, device, generator)
        self.w_up = new_param((d, f), dt, device, generator)
        self.w_down = new_param((f, d), dt, device, generator)


class DenseLayer(nn.Module):
    """norm1, attention, [norm2,] FFN (no norm2 in a parallel block)."""
    AXES = {"norm1": ("embed",), "norm2": ("embed",)}

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.norm1 = norm_param(cfg.d_model, cfg.norm, device)
        self.attn = Attention(cfg, device, generator)
        if not cfg.parallel_block:
            self.norm2 = norm_param(cfg.d_model, cfg.norm, device)
        self.ffn = MLP(cfg, device, generator)


class Transformer(nn.Module):
    """embed (V, d), final_norm (d,), lm_head (d, V) when untied, and
    ``groups``: one ``nn.ModuleList`` of layers a group."""
    AXES = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "lm_head": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        check_ported(cfg)
        dt = model_dtype(cfg)
        self.embed = new_param((cfg.vocab_size, cfg.d_model), dt, device,
                               generator, init="embed")
        self.final_norm = norm_param(cfg.d_model, cfg.norm, device)
        if not cfg.tie_embeddings:
            self.lm_head = new_param((cfg.d_model, cfg.vocab_size), dt,
                                     device, generator)
        self.groups = nn.ModuleList(
            nn.ModuleList(DenseLayer(cfg, device, generator)
                          for _ in range(count))
            for _, count in layer_groups(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> Transformer:
    """The model with weights drawn as the reference draws them: normals
    truncated to [-2, 2] times the fan-in scale (``embed`` times 0.02), in
    float32 from ``generator`` (on ``device``), cast to ``cfg.dtype``; norm
    weights float32 zeros (RMSNorm) or ones (LayerNorm).  ``device`` defaults
    to the card and raises without one; ``device="meta"`` allocates nothing
    and needs no generator.  The draws are torch's, not JAX's: to hold the
    port against the reference, carry its weights across with
    ``convert.model_from_reference``."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params draws from an explicit torch.Generator "
                         "(on the model's device)")
    return Transformer(cfg, dev, generator)


# ---------------------------------------------------------------- forward


def _attn_sublayer(p: Attention, x, positions, cfg: ModelConfig, *, window,
                   cache=None, pos=None):
    """GQA attention.  cache None -> full-sequence, returning this layer's
    (k, v); else single-token decode at position ``pos`` (an int) against a
    {'k','v','kv_pos'} (ring-)cache, into which this token is written in
    place first."""
    q = torch.einsum("bsd,dhe->bshe", x, p.wq)
    k = torch.einsum("bsd,dhe->bshe", x, p.wk)
    v = torch.einsum("bsd,dhe->bshe", x, p.wv)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm)
        k = rmsnorm(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = attn_lib.attention(q, k, v, causal=True, window=window,
                               q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        new_kv = (k, v)
    else:
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["kv_pos"][:, slot] = pos
        o = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                      cache["kv_pos"], pos, window=window)
        new_kv = cache
    out = torch.einsum("bshe,hed->bsd", o, p.wo)
    return out, new_kv


def _mlp(p: MLP, x):
    return swiglu(x, p.w_gate, p.w_up, p.w_down)


def _dense_layer(p: DenseLayer, x, positions, cfg, cache=None, pos=None):
    """One dense layer.  Returns (x, new_cache or this layer's (k, v))."""
    window = cfg.window if cfg.attention == "sliding" else None
    h = apply_norm(x, p.norm1, cfg.norm)
    attn_out, new_cache = _attn_sublayer(p.attn, h, positions, cfg,
                                         window=window, cache=cache, pos=pos)
    if cfg.parallel_block:
        ff = _mlp(p.ffn, h)
        x = x + cfg.residual_scale * (attn_out + ff)
    else:
        x = x + cfg.residual_scale * attn_out
        h2 = apply_norm(x, p.norm2, cfg.norm)
        x = x + cfg.residual_scale * _mlp(p.ffn, h2)
    return x, new_cache


def _layer_cache(cache_g, count: int, i: int):
    if cache_g is None or count == 1:
        return cache_g
    return {name: c[i] for name, c in cache_g.items()}


@torch.no_grad()
def forward(model: Transformer, tokens, cfg: ModelConfig, *, positions=None,
            caches=None, pos=None, last_only: bool = False):
    """Full forward.  tokens (B,S) integer.  With ``caches``, a single-token
    step at position ``pos`` (an int) that writes each layer's new key and
    value into the caches in place.  ``last_only``: the final norm and the
    head at the last position alone, logits (B,1,V), which is all a prefill
    keeps.

    Returns (logits (B,S,V) in the model dtype, aux_loss (0 for dense
    layers), new_caches): with caches, the same cache objects; without,
    each group's per-layer (k, v) of the whole sequence (a list of them a
    group, one pair for a group of one layer).
    """
    x = (model.embed[tokens] * cfg.embed_scale).to(model_dtype(cfg))
    b, s = x.shape[:2]
    if positions is None:
        positions = (torch.full((b, s), pos, device=x.device)
                     if caches is not None else
                     torch.arange(s, device=x.device)[None].expand(b, s))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for gi, (_, count) in enumerate(layer_groups(cfg)):
        cache_g = None if caches is None else caches[gi]
        kvs = []
        for li, layer in enumerate(model.groups[gi]):
            x, kv = _dense_layer(layer, x, positions, cfg,
                                 cache=_layer_cache(cache_g, count, li),
                                 pos=pos)
            kvs.append(kv)
        new_caches.append(cache_g if caches is not None else
                          (kvs[0] if count == 1 else kvs))

    if last_only:
        x = x[:, -1:]
    x = apply_norm(x, model.final_norm, cfg.norm)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = torch.einsum("bsd,dv->bsv", x, head) * cfg.logit_scale
    return logits, aux_total, new_caches


# ---------------------------------------------------------------- decode


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None):
    """Zeroed caches matching ``forward``'s ``caches`` argument, on
    ``device`` (default: the card, raising without one).  Full attention
    allocates (B, max_len, ...); sliding-window attention a ring of
    ``min(window, max_len)`` slots.  ``kv_pos`` starts at -1 (empty)."""
    check_ported(cfg)
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    hk, dh = cfg.num_kv_heads, cfg.head_dim_
    window = cfg.window if cfg.attention == "sliding" else None
    t = min(window, max_len) if window else max_len
    caches = []
    for _, count in layer_groups(cfg):
        lead = (count,) if count > 1 else ()
        caches.append({
            "k": torch.zeros(lead + (batch, t, hk, dh), dtype=dt, device=dev),
            "v": torch.zeros(lead + (batch, t, hk, dh), dtype=dt, device=dev),
            "kv_pos": torch.full(lead + (batch, t), -1, dtype=torch.int32,
                                 device=dev)})
    return caches


def fill_decode_caches(cfg: ModelConfig, caches, kvs) -> None:
    """Write a full-sequence ``forward``'s per-layer (k, v) of positions
    0..S-1 into zeroed ``caches`` in place: each position at slot
    ``pos % T``, a ring keeping the last T positions, as S single-token
    decode steps would leave it."""
    for (_, count), cache_g, kv_g in zip(layer_groups(cfg), caches, kvs):
        for li, (k, v) in enumerate([kv_g] if count == 1 else kv_g):
            c = _layer_cache(cache_g, count, li)
            s, t = k.shape[1], c["k"].shape[1]
            first = max(0, s - t)
            held = torch.arange(first, s, device=k.device)
            slots = held % t
            c["k"][:, slots] = k[:, first:]
            c["v"][:, slots] = v[:, first:]
            c["kv_pos"][:, slots] = held.to(torch.int32)


def decode_step(model: Transformer, caches, tokens, pos, cfg: ModelConfig):
    """One token for every sequence.  tokens (B,1), pos the current
    position (an int, or a 0-d integer tensor, read once on the host).
    Returns (logits (B,1,V), caches), the caches updated in place."""
    logits, _, new_caches = forward(model, tokens, cfg, caches=caches,
                                    pos=int(pos))
    return logits, new_caches
