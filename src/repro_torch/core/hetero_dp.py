"""Serving steps of ``repro/core/hetero_dp.py``.

Only ``make_prefill_step`` and ``make_serve_step`` are ported so far; the
capacity-masked loss and train step come with the training slice
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model_factory import Model


def make_prefill_step(model: Model) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits
    return prefill_step


def make_serve_step(model: Model) -> Callable:
    @torch.no_grad()
    def serve_step(params, cache, tokens, aux=None):
        return model.decode_step(params, cache, tokens, aux)
    return serve_step
