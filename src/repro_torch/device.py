"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
card that default raises: the port never drops to the CPU on its own.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default, and torch sees "
            "no CUDA device here; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
