"""Family dispatch; port of ``repro/models/model_factory.py`` (dense only).

Model:
  init(seed, device)                         -> params
  forward(params, batch)                     -> (logits, aux_loss)
  init_cache(params, B, max_len, dtype, aux) -> cache
  decode_step(params, cache, tokens, aux)    -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable


def build_model(cfg: ArchConfig) -> Model:
    transformer.check_ported(cfg)
    mod = transformer
    return Model(
        cfg=cfg,
        init=lambda seed, device="cuda": mod.init(seed, cfg, device),
        forward=lambda params, batch: mod.forward(params, cfg, batch),
        init_cache=lambda params, b, mlen, dtype, aux=None: mod.init_cache(
            params, cfg, b, mlen, dtype, aux),
        decode_step=lambda params, cache, tok, aux=None: mod.decode_step(
            params, cfg, cache, tok, aux),
    )


def aux_inputs(cfg: ArchConfig, batch_size: int, seq_len: int) -> Dict[str, Any]:
    """Modality-frontend inputs; none for the dense family."""
    transformer.check_ported(cfg)
    return {}
