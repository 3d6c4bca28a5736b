"""Flash-attention forward: the CUDA kernel and its plain version.

Port of ``repro/kernels/flash_attention.py``. Layout contract: q
(B, Hq, Sq, D), k/v (B, Hkv, Sk, D), out (B, Hq, Sq, D) in q's dtype.

``flash_attention`` launches ``csrc/flash_attention_fwd.cu`` for a CUDA
tensor, and runs ``flash_attention_plain`` for a CPU tensor. On the card
it never falls back: a kernel that does not build or launch raises.
``block_q`` / ``block_k`` are the TPU kernel's VMEM tiling hints; the
plain version tiles by them, the CUDA kernel picks its own tiles (64
query rows by 32 keys) and ignores them.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import NEG_INF

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Number of times the CUDA kernel was launched (the plain path never counts).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0, block_q: int = 128,
                          block_k: int = 512) -> torch.Tensor:
    """Plain-torch version of the TPU kernel, tile by tile.

    Same masks, GQA map (query head h reads KV head h // group), tail
    padding and running f32 (m, l, acc) per (q tile, kv tile) as
    ``_attn_kernel``. A masked key contributes p = 0, as in the CUDA
    kernel: for every row with a live key this is the reference's
    arithmetic exactly, and a row that every key masks comes out as 0.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    group = hq // hkv
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    pq = (-sq) % block_q
    pk = (-sk) % block_k
    q32 = F.pad(q.float(), (0, 0, 0, pq))
    k32 = F.pad(k.float(), (0, 0, 0, pk)).repeat_interleave(group, dim=1)
    v32 = F.pad(v.float(), (0, 0, 0, pk)).repeat_interleave(group, dim=1)
    scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, sq + pq, d), dtype=q.dtype, device=q.device)
    ar_q = torch.arange(block_q, device=q.device)[:, None]
    ar_k = torch.arange(block_k, device=q.device)[None, :]
    for q_start in range(0, sq + pq, block_q):
        qt = q32[:, :, q_start:q_start + block_q]
        m = torch.full((b, hq, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, block_q), device=q.device)
        acc = torch.zeros((b, hq, block_q, d), device=q.device)
        for k_start in range(0, sk + pk, block_k):
            if causal and q_start + block_q - 1 < k_start:
                continue
            if sliding_window and q_start - (k_start + block_k - 1) >= sliding_window:
                continue
            kt = k32[:, :, k_start:k_start + block_k]
            vt = v32[:, :, k_start:k_start + block_k]
            s = (qt @ kt.transpose(-1, -2)) * scale
            q_pos = q_start + ar_q
            k_pos = k_start + ar_k
            allow = k_pos < sk
            if causal:
                allow = allow & (q_pos >= k_pos)
            if sliding_window:
                allow = allow & ((q_pos - k_pos) < sliding_window)
            s = torch.where(allow, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(allow, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vt
            m = m_new
        out[:, :, q_start:q_start + block_q] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out[:, :, :sq]


def check_kernel_inputs(q, k, v) -> None:
    """Raise ValueError for what the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, S, D) tensors")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"{hq} query heads are not a multiple of {k.shape[1]} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the CUDA kernel "
                         f"(built for {HEAD_DIMS})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, all three alike")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point, built and loaded on first use."""
    from repro_torch.kernels import _build

    fn = _build.load(KERNEL).flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal: bool, sliding_window: int) -> torch.Tensor:
    global LAUNCHES
    check_kernel_inputs(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    # Written as (B, Sq, Hq, D) so the model's reshape back is free.
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _kernel_fn()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
                 ctypes.cast(strides, ctypes.c_void_p), 1.0 / (d ** 0.5),
                 int(causal), int(sliding_window), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    block_q: int = 128, block_k: int = 512) -> torch.Tensor:
    """Forward attention; the CUDA kernel on the card, plain on the CPU."""
    if q.is_cuda:
        return _launch(q, k, v, causal, sliding_window)
    return flash_attention_plain(q, k, v, causal=causal,
                                 sliding_window=sliding_window,
                                 block_q=block_q, block_k=block_k)
