"""Attention: GQA with dense / chunked (flash-style) / windowed / decode paths.

The port of ``repro.models.attention``, written as the reference's own math
in torch ops: the masked softmax of ``dense_attention`` and the online
softmax over chunks of ``chunked_attention``, scores and softmax in float32,
the output cast to the input's dtype.  No library attention
(``scaled_dot_product_attention``) is used: parity with the reference is
the point, and a Hopper attention kernel is later work.

``chunked_attention`` never materializes the (S x T) score matrix, only one
(q chunk x kv chunk) block at a time.  The reference scans every kv chunk
past every q chunk, and in the sliding-window path a fixed number of chunk
offsets down from the diagonal, clipping those outside the kv chunks and
masking them whole.  A block masked whole adds exactly zero to a row's
online sums once the row has met a visible column (its ``exp`` is 0 and its
correction 1), and before that its sums are wiped by the first visible
block (correction ``exp(-1e30 - m) = 0``).  So the port skips the kv chunks
above the causal diagonal and the clipped offsets, with the same result.

Query head ``h`` uses kv head ``h // G`` (``G = H / Hk``), as the
reference's ``_split_heads`` lays them out.  Supports Dq != Dv.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _split_heads(q, num_kv_heads):
    """(B,S,H,D) -> (B,S,Hk,G,D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, d)


def dense_attention(q, k, v, *, causal=True, window=None, scale=None,
                    q_offset=0):
    """Reference attention.  q (B,S,H,Dq), k (B,T,Hk,Dq), v (B,T,Hk,Dv).

    ``q_offset``: global position of q[0] (for decode-style suffix queries).
    """
    b, s, h, dq = q.shape
    t, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dq ** -0.5
    qh = _split_heads(q, hk).float()
    s_mat = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    rows = q_offset + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s_mat = torch.where(mask, s_mat, NEG_INF)
    p = torch.softmax(s_mat, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def _online_update(carry, s_blk, v_blk):
    """One online-softmax accumulation step.
    carry: (acc (..,q,Dv), row_max (..,q), row_sum (..,q));
    s_blk: (.., q, kblk) scores (already masked), v_blk (B,kblk,Hk,Dv)."""
    acc, row_max, row_sum = carry
    blk_max = torch.amax(s_blk, dim=-1)
    new_max = torch.maximum(row_max, blk_max)
    corr = torch.exp(row_max - new_max)
    p = torch.exp(s_blk - new_max[..., None])                # (b,hk,g,q,kblk)
    row_sum = row_sum * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.float())
    acc = acc * corr[..., None] + pv
    return acc, new_max, row_sum


def chunked_attention(q, k, v, *, causal=True, window=None,
                      q_chunk=512, kv_chunk=512, scale=None):
    """Flash-style attention.  Same contract as dense_attention (q_offset=0,
    S == T self-attention)."""
    b, s, h, dq = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[-1]
    if s != t:
        raise ValueError("chunked_attention is for self-attention (S == T)")
    scale = scale if scale is not None else dq ** -0.5
    g = h // hk
    dev = q.device

    cq = min(q_chunk, s)
    ck = min(kv_chunk, t)
    s_pad = -(-s // cq) * cq
    t_pad = -(-t // ck) * ck
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, s_pad - s))
    kp = pad(k, (0, 0, 0, 0, 0, t_pad - t))
    vp = pad(v, (0, 0, 0, 0, 0, t_pad - t))
    nq, nk = s_pad // cq, t_pad // ck

    rows_in_chunk = torch.arange(cq, device=dev)
    cols_in_chunk = torch.arange(ck, device=dev)

    def elem_mask(qi, kj):
        rows = qi * cq + rows_in_chunk[:, None]            # (cq, 1)
        cols = kj * ck + cols_in_chunk[None, :]            # (1, ck)
        m = (cols < t).expand(cq, ck)                      # mask kv padding
        if causal:
            m = m & (cols <= rows)
        if window is not None:
            m = m & (cols > rows - window)
        return m

    def kv_block(carry, qc, qi, kj):
        kc = kp[:, kj * ck:(kj + 1) * ck]
        vc = vp[:, kj * ck:(kj + 1) * ck]
        s_blk = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc.float()) * scale
        s_blk = torch.where(elem_mask(qi, kj), s_blk, NEG_INF)
        return _online_update(carry, s_blk, vc)

    if window is None:
        last_kv = (lambda qi: min(nk - 1, (qi * cq + cq - 1) // ck)) \
            if causal else (lambda qi: nk - 1)
        order = lambda qi: range(last_kv(qi) + 1)         # noqa: E731
    else:
        # sliding window: q chunk qi needs cols [qi*cq - window + 1,
        # qi*cq + cq - 1], i.e. at most this many kv chunks, counting down
        # from the diagonal one (chunk grids of q and kv need not be
        # aligned)
        n_chunks = -(-(window + cq - 1) // ck) + 1

        def order(qi):
            kj_hi = (qi * cq + cq - 1) // ck               # diagonal kv chunk
            return [kj_hi - off for off in range(n_chunks)
                    if 0 <= kj_hi - off < nk]

    out = torch.empty((b, s_pad, h, dv), dtype=torch.float32, device=dev)
    for qi in range(nq):
        qc = _split_heads(qp[:, qi * cq:(qi + 1) * cq], hk).float()
        carry = (torch.zeros((b, hk, g, cq, dv), dtype=torch.float32,
                             device=dev),
                 torch.full((b, hk, g, cq), NEG_INF, dtype=torch.float32,
                            device=dev),
                 torch.zeros((b, hk, g, cq), dtype=torch.float32, device=dev))
        for kj in order(qi):
            carry = kv_block(carry, qc, qi, kj)
        acc, _, rs = carry
        o = acc / torch.clamp(rs[..., None], min=1e-30)     # (b,hk,g,cq,dv)
        out[:, qi * cq:(qi + 1) * cq] = o.permute(0, 3, 1, 2, 4).reshape(
            b, cq, h, dv)
    return out[:, :s].to(q.dtype)


def attention(q, k, v, *, causal=True, window=None, scale=None,
              q_chunk=512, kv_chunk=1024, dense_below=1024):
    """Dispatch: dense for short sequences, chunked beyond."""
    if q.shape[1] <= dense_below:
        return dense_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *,
                     window=None, scale=None):
    """Single-token decode vs. a (ring-)cache.

    q (B,1,H,Dq); caches (B,T,Hk,D*); kv_positions (B,T) int32 — the global
    position each cache slot holds (-1 = empty; ring caches wrap);
    pos an int, a 0-d or a (B,) integer tensor, the current position.
    Returns (B,1,H,Dv).
    """
    b, _, h, dq = q.shape
    hk = k_cache.shape[2]
    scale = scale if scale is not None else dq ** -0.5
    qh = _split_heads(q, hk).float()                        # (B,1,Hk,G,Dq)
    s_mat = torch.einsum("bqhgd,bthd->bhgqt", qh, k_cache.float()) * scale
    if isinstance(pos, int):        # compared on the device, no copy
        pos_b = pos
    else:
        pos = torch.as_tensor(pos, device=q.device)
        pos_b = (pos if pos.ndim else pos[None].expand(b))[:, None]
    valid = (kv_positions >= 0) & (kv_positions <= pos_b)
    if window is not None:
        valid &= kv_positions > (pos_b - window)
    s_mat = torch.where(valid[:, None, None, None, :], s_mat, NEG_INF)
    p = torch.softmax(s_mat, dim=-1)
    out = torch.einsum("bhgqt,bthd->bqhgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)
