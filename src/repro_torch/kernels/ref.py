"""Plain-torch attention oracles, ported from ``repro/kernels/ref.py``.

  * ``attention_naive``   — the O(Sq*Sk) einsum form (ground truth).
  * ``attention_blocked`` — the same function as an online softmax over
    KV blocks, O(Sq*block_k) memory.

Both keep the reference's ``NEG_INF``, ``q_offset`` and ``kv_mask``
semantics, the tail-pad mask and the ``max(l, 1e-30)`` clamp. Layout is
the model's (B, S, H, D).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _gqa_expand(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hq, D) by repeating KV heads."""
    hkv = k.shape[2]
    if hkv == num_q_heads:
        return k
    return k.repeat_interleave(num_q_heads // hkv, dim=2)


def attention_naive(
    q: torch.Tensor,               # (B, Sq, Hq, D)
    k: torch.Tensor,               # (B, Sk, Hkv, D)
    v: torch.Tensor,               # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,             # absolute position of q[0] (decode)
    kv_mask: Optional[torch.Tensor] = None,   # (B, Sk) 1=valid
) -> torch.Tensor:
    """O(Sq*Sk) oracle attention."""
    hq = q.shape[2]
    k32 = _gqa_expand(k, hq).float()
    v32 = _gqa_expand(v, hq).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k32) * scale
    sq, sk = q.shape[1], k.shape[1]
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if sliding_window:
        mask &= q_pos[:, None] - k_pos[None, :] < sliding_window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :].bool(), scores, NEG_INF)
    probs = F.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v32)
    return out.to(q.dtype)


def attention_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
    kv_mask: Optional[torch.Tensor] = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks (O(Sq*block_k) memory)."""
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if sk % block_k:
        pad = block_k - sk % block_k
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        valid = torch.ones((b, sk), device=q.device)
        if kv_mask is not None:
            valid = kv_mask.float()
        kv_mask = torch.cat([valid, torch.zeros((b, pad), device=q.device)],
                            dim=1)
        sk += pad
    # scale folded into q up front, as the reference does
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    q32 = q.float() * scale
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for start in range(0, sk, block_k):
        kc = _gqa_expand(k[:, start:start + block_k], hq).float()
        vc = _gqa_expand(v[:, start:start + block_k], hq).float()
        k_pos = start + torch.arange(block_k, device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kc)
        allow = torch.ones((sq, block_k), dtype=torch.bool, device=q.device)
        if causal:
            allow = allow & (q_pos[:, None] >= k_pos[None, :])
        if sliding_window:
            allow = allow & (q_pos[:, None] - k_pos[None, :] < sliding_window)
        allow = allow[None, None]
        if kv_mask is not None:
            maskc = kv_mask[:, start:start + block_k].bool()
            allow = allow & maskc[:, None, None, :]
        s = torch.where(allow, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
