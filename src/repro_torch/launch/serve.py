"""LM serving: prefill and batched decode steps, and a greedy generator.

The port of ``repro.launch.serve`` for the dense decoder families.  The CLI
serves a model with batched random requests:

    python -m repro_torch.launch.serve --arch minicpm-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch minicpm-2b --smoke   # the card

Without ``--device`` it needs a CUDA card and raises without one.  Weights
and prompts come from ``torch.Generator``s seeded with ``--seed`` on the
serving device (the reference draws with ``jax.random``, so the two CLIs
serve different random models; the tests carry the reference's weights
across with ``convert.model_from_reference``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import registry, transformer


def make_prefill_step(cfg):
    """(model, {'tokens': (B,S)}) -> last-position logits (B, V)."""
    transformer.check_ported(cfg)

    def prefill(model, batch):
        logits, _, _ = transformer.forward(model, batch["tokens"], cfg,
                                           last_only=True)
        return logits[:, -1]
    return prefill


def make_decode_step(cfg):
    """(model, caches, tokens (B,1), pos) -> (logits (B,1,V), caches)."""
    return registry.decode_step_fn(cfg)


def prefill(cfg, model, prompt_tokens, max_len: int):
    """One full-sequence forward over the prompt -> (the last position's
    logits (B, V), decode caches of ``max_len`` positions holding the
    prompt's keys and values)."""
    b = prompt_tokens.shape[0]
    caches = registry.init_decode_caches(cfg, b, max_len,
                                         prompt_tokens.device)
    logits, _, kvs = transformer.forward(model, prompt_tokens, cfg,
                                         last_only=True)
    transformer.fill_decode_caches(cfg, caches, kvs)
    return logits[:, -1], caches


def greedy_generate(cfg, model, prompt_tokens, *, max_new: int = 32,
                    return_logits: bool = False):
    """Incremental greedy decoding: the prompt (B, S0) integer tokens on the
    model's device -> (B, S0 + max_new) tokens, the prompt first.

    The reference builds the prompt's caches by replaying single-token
    decode steps (its cache write is single-token), then scores the prompt
    with one prefill forward.  The port fills the caches from that one
    forward (:func:`prefill`): the same keys and values, computed once.  Then
    ``max_new`` decode steps, each token the first maximal logit
    (``torch.argmax``, as ``jnp.argmax``) of the model-dtype logits.

    ``return_logits``: also return the float32 logits that chose each token
    and the last step's, (B, max_new + 1, V): entry j is the distribution
    at position S0 - 1 + j.
    """
    b, s0 = prompt_tokens.shape
    max_len = s0 + max_new
    step = make_decode_step(cfg)
    logits, caches = prefill(cfg, model, prompt_tokens, max_len)
    out, seen = [prompt_tokens], [logits.float()] if return_logits else None
    for t in range(s0, max_len):
        nxt = torch.argmax(logits, dim=-1).to(prompt_tokens.dtype)[:, None]
        out.append(nxt)
        step_logits, caches = step(model, caches, nxt, t)
        logits = step_logits[:, -1]
        if return_logits:
            seen.append(logits.float())
    tokens = torch.cat(out, dim=1)
    if return_logits:
        return tokens, torch.stack(seen, dim=1)
    return tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description="greedy LM serving (dense "
                                             "decoder families)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to serve on the CPU (default: the CUDA "
                         "card, raising without one)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = registry.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    t0 = time.perf_counter()
    out = greedy_generate(cfg, model, prompts, max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served batch={args.batch} new_tokens={args.max_new} on {dev} "
          f"in {dt:.2f}s ({args.batch * args.max_new / dt:.1f} tok/s)")
    print("sample:", out[0, -args.max_new:].tolist())
    return out


if __name__ == "__main__":
    main()
