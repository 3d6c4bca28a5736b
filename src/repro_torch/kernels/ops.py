"""Kernel entry points used by the models; port of ``repro/kernels/ops.py``.

Dispatch for ``attention`` (no environment variable takes part):
  * default — ``flash_attention``: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor. It covers ``kv_mask is None and
    q_offset == 0``, which is every dense caller on the serving path;
    anything else raises ``NotImplementedError``.
  * ``impl="plain"`` — ``flash_attention_plain`` on any device.
  * ``impl="blocked"`` / ``impl="naive"`` — the oracles of ``ref.py``,
    which also take ``kv_mask`` and ``q_offset`` (tests only).
``forced_impl`` sets the default for a ``with`` block, so a caller can
run a whole model through one of the plain versions to compare.

Models keep the (B, S, H, D) layout; this module adapts to the kernel's.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

IMPLS = ("plain", "blocked", "naive")
_forced: Optional[str] = None


@contextlib.contextmanager
def forced_impl(impl: str) -> Iterator[None]:
    """Run every ``attention`` call in the block through ``impl``."""
    global _forced
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    prev, _forced = _forced, impl
    try:
        yield
    finally:
        _forced = prev


def attention(
    q: torch.Tensor,               # (B, Sq, Hq, D)
    k: torch.Tensor,               # (B, Sk, Hkv, D)
    v: torch.Tensor,               # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
    q_offset: int = 0,
    kv_mask: Optional[torch.Tensor] = None,
    impl: Optional[str] = None,
    block_q: int = 128,
    block_k: int = 512,
) -> torch.Tensor:
    """Multi-head (GQA) attention with causal / sliding-window masking."""
    impl = impl or _forced
    if impl == "naive":
        return _ref.attention_naive(
            q, k, v, causal=causal, sliding_window=sliding_window,
            q_offset=q_offset, kv_mask=kv_mask)
    if impl == "blocked":
        return _ref.attention_blocked(
            q, k, v, causal=causal, sliding_window=sliding_window,
            q_offset=q_offset, kv_mask=kv_mask, block_k=block_k)
    if impl not in (None, "plain"):
        raise ValueError(f"impl {impl!r} not in {IMPLS}")
    if kv_mask is not None or q_offset != 0:
        raise NotImplementedError(
            "the flash-attention kernel takes no kv_mask or q_offset yet "
            "(ROADMAP.md, Queue 2); pass impl='blocked' for the reference")
    fn = _fa.flash_attention_plain if impl == "plain" else _fa.flash_attention
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             causal=causal, sliding_window=sliding_window,
             block_q=block_q, block_k=block_k)
    return out.transpose(1, 2)


def decode_attention(
    q: torch.Tensor,               # (B, 1, Hq, D)
    k_cache: torch.Tensor,         # (B, Sk, Hkv, D)
    v_cache: torch.Tensor,
    *,
    q_offset,                      # (B,) or scalar absolute position
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache.

    Plain torch, as in the reference: it has no Pallas kernel there.
    """
    b, sk, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    q32 = q.float().reshape(b, hkv, g, d)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d)))
    s = torch.einsum("bhgd,bkhd->bhgk", q32, k_cache.float()) * scale
    k_pos = torch.arange(sk, device=q.device)
    offs = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    allow = k_pos[None, :] <= offs
    if kv_mask is not None:
        allow = allow & kv_mask.bool()
    s = torch.where(allow[:, None, None, :], s, _ref.NEG_INF)
    p = F.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)
