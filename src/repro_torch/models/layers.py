"""Shared model layers, ported from ``repro/models/layers.py``.

Functions on tensors. ``p`` is any mapping from leaf name to tensor: an
``nn.ParameterDict`` of the model, or a plain dict in the tests. Leaf
names and (in, out) weight layouts follow the reference's contract:
  attention: wq (E, Hq*D), wk/wv (E, Hkv*D), wo (Hq*D, E), bq/bk/bv
  mlp:       w_gate/w_up (E, F), w_down (F, E)
  norms:     scale (E,)
  embeds:    embedding (V, E), lm_head (E, V)
so ``x @ w`` here is ``x @ w`` there, and weights need no transpose.
Weights are stored in the compute dtype (norm scales in f32, as the
reference reads them); the ``.to(dt)`` casts below are then no-ops.
The sharding markers of the reference are no-ops on one card and are
dropped.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

Params = Mapping[str, torch.Tensor]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def padded_vocab(cfg: ArchConfig, multiple: int = 256) -> int:
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# init helpers (same distributions as the reference, drawn from a Generator)
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim/2) in f32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos_, sin_ = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos_, sin_ = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    o1 = x1 * cos_ - x2 * sin_
    o2 = x2 * cos_ + x1 * sin_
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor):
    dt = x.dtype
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    b, s = x.shape[:2]
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def attention_block(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,                           # (B, S, E)
    *,
    positions: Optional[torch.Tensor] = None,  # (S,) or (B, S)
    causal: bool = True,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence self-attention (prefill). The reference's cross-
    attention arguments belong to the VLM family, which is not ported."""
    q, k, v = _project_qkv(p, cfg, x)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = ops.attention(q, k, v, causal=causal,
                        sliding_window=cfg.sliding_window, kv_mask=kv_mask)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def attention_decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,                     # (B, 1, E)
    k_cache: torch.Tensor,               # (B, Smax, Hkv, D)
    v_cache: torch.Tensor,
    pos: torch.Tensor,                   # (B,) absolute position of new token
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention; writes the new KV at ``pos`` (ring for SWA).

    Unlike the reference, the caches are updated in place (no second
    copy of the cache per step); they are also returned.
    """
    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    smax = k_cache.shape[1]
    slot = pos % smax if cfg.sliding_window else torch.clamp(pos, max=smax - 1)
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    if cfg.sliding_window:
        # ring buffer: every slot written within the last `smax` steps is live
        slot_pos = torch.arange(smax, device=x.device)[None, :]
        age = (slot[:, None] - slot_pos) % smax
        kv_mask = age < torch.clamp(pos + 1, max=smax)[:, None]
        big = torch.iinfo(torch.int32).max // 2
        out = ops.decode_attention(q, k_cache, v_cache,
                                   q_offset=pos[:, None] * 0 + big,
                                   kv_mask=kv_mask)
    else:
        out = ops.decode_attention(q, k_cache, v_cache, q_offset=pos)
    out = out.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def embed(p: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["embedding"].to(compute_dtype(cfg)))


def logits(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["embedding"].T.to(x.dtype)
    return x @ p["lm_head"].to(x.dtype)
