"""Architecture configs: the port's copy of ``repro/configs/base.py``.

The dataclasses and ``reduced_config`` are copied field for field, so a
config built here equals the reference's under ``dataclasses.asdict``.
Only the architectures the port runs are registered; ``get_arch`` of any
other name raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    # capacity factor for dispatch buffers (tokens per expert = tokens/E * cf)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # aux load-balance loss weight (switch-transformer style)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int          # N, per-head SSM state size
    head_dim: int = 64      # P, channels per SSD head
    chunk_size: int = 256   # SSD block length
    conv_width: int = 4     # depthwise causal conv width
    expand: int = 2         # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 = full attention
    activation: str = "swiglu"    # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0    # 0 = no interleaved attention
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_encoder_len: int = 1500
    dtype: str = "bfloat16"
    shapes: Optional[Tuple[str, ...]] = None
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0


_ARCHS: Dict[str, ArchConfig] = {}

# The reference registers ten architectures; the port has these so far
# (ROADMAP.md Queue 1 lists the rest).
_ARCH_MODULES = ["deepseek_7b"]


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _ARCHS[cfg.name] = cfg
    return cfg


def load_all_archs() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchConfig:
    load_all_archs()
    if name not in _ARCHS:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet "
                       f"(see ROADMAP.md); ported: {sorted(_ARCHS)}")
    return _ARCHS[name]


def list_archs() -> Sequence[str]:
    load_all_archs()
    return sorted(_ARCHS)


def reduced_config(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: Dict[str, object] = dict(
        num_layers=2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16 if cfg.num_heads else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        num_image_tokens=16 if cfg.num_image_tokens else 0,
        max_encoder_len=32 if cfg.is_encoder_decoder else cfg.max_encoder_len,
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            num_experts=4, top_k=2, expert_d_ff=64,
            capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(state_dim=16, head_dim=16, chunk_size=16,
                                   conv_width=cfg.ssm.conv_width, expand=2)
    if cfg.hybrid_attn_every:
        changes["hybrid_attn_every"] = 2
    if cfg.cross_attn_every:
        changes["cross_attn_every"] = 2
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
