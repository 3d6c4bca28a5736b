"""Carry the reference's weights into the port.

``params_from_jax`` takes the JAX parameter pytree after
``jax.tree.map(np.asarray, params)`` — nested dicts of numpy arrays — and
builds the port's parameter tree. Every ``layers`` leaf of the reference
has a leading L dim (the stacked layers of layers.py's naming contract);
it is split into one tensor per layer. Both packages store weights as
(in, out), so nothing is transposed. Any leaf the port does not expect,
any leaf it expects and does not find, and any shape that differs raise
``ValueError``. This module reads numpy arrays only and imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import compute_dtype


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(sub, Mapping):
            out.update(_flatten(sub, path))
        else:
            out[path] = np.asarray(sub)
    return out


def _unstack_layers(flat: Dict[str, np.ndarray], num_layers: int
                    ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        if not path.startswith("layers/"):
            out[path] = arr
            continue
        if arr.ndim == 0 or arr.shape[0] != num_layers:
            raise ValueError(f"{path}: stacked leaf of shape {arr.shape} has "
                             f"no leading dim of {num_layers} layers")
        rest = path[len("layers/"):]
        for i in range(num_layers):
            out[f"layers/{i}/{rest}"] = arr[i]
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: ArchConfig,
                    device="cuda", dtype: Optional[torch.dtype] = None
                    ) -> nn.ModuleDict:
    """Load the reference's params into the port's tree, on ``device``,
    in ``dtype`` (default: the config's compute dtype)."""
    dev = resolve_device(device)
    dt = dtype or compute_dtype(cfg)
    flat = _unstack_layers(_flatten(tree), cfg.num_layers)
    specs = {path: shape for path, shape, _ in transformer.param_specs(cfg)}
    unused = sorted(set(flat) - set(specs))
    missing = sorted(set(specs) - set(flat))
    if unused or missing:
        raise ValueError(f"params do not match {cfg.name}: unused leaves "
                         f"{unused}, missing leaves {missing}")
    bad = [f"{p}: {flat[p].shape} != {s}" for p, s in specs.items()
           if tuple(flat[p].shape) != tuple(s)]
    if bad:
        raise ValueError("shape mismatch: " + "; ".join(bad))
    tensors = {p: torch.from_numpy(np.array(flat[p], dtype=np.float32))
               .to(device=dev, dtype=transformer.leaf_dtype(p, dt))
               for p in specs}
    return transformer.assemble(cfg, tensors)
