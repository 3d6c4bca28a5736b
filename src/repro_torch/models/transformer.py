"""Decoder-only transformer, dense family; port of ``repro/models/transformer.py``.

Parameters are a tree of ``nn.ModuleDict`` / ``nn.ParameterDict`` with the
reference's leaf names; the stacked layers of the reference (a leading L
dim driven by ``lax.scan``) become an ``nn.ModuleList`` and a Python loop.
``param_specs`` is the one description of that tree: ``init`` draws it and
``bridge.params_from_jax`` checks the reference's leaves against it.
MoE and VLM configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

# (path, shape, init): init is ("normal", std), ("ones",) or ("zeros",)
Spec = Tuple[str, Tuple[int, ...], Tuple]


def check_ported(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP.md Queue 1, models/moe.py)")
    if cfg.cross_attn_every:
        raise NotImplementedError("VLM cross-attention is not ported yet "
                                  "(ROADMAP.md Queue 1, VLM segments)")


def param_specs(cfg: ArchConfig) -> List[Spec]:
    """Every leaf of the parameter tree, per layer, in a fixed order."""
    check_ported(cfg)
    E, F = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    V = L.padded_vocab(cfg)
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5

    def dense(fan_in: int, scale: float = 1.0):
        return ("normal", scale / fan_in ** 0.5)

    specs: List[Spec] = [("embed/embedding", (V, E), ("normal", 0.02))]
    if not cfg.tie_embeddings:
        specs.append(("embed/lm_head", (E, V), dense(E)))
    for i in range(cfg.num_layers):
        pre = f"layers/{i}"
        specs += [
            (f"{pre}/norm1/scale", (E,), ("ones",)),
            (f"{pre}/attn/wq", (E, hq * hd), dense(E)),
            (f"{pre}/attn/wk", (E, hkv * hd), dense(E)),
            (f"{pre}/attn/wv", (E, hkv * hd), dense(E)),
            (f"{pre}/attn/wo", (hq * hd, E), dense(hq * hd, out_scale)),
        ]
        if cfg.qkv_bias:
            specs += [(f"{pre}/attn/bq", (hq * hd,), ("zeros",)),
                      (f"{pre}/attn/bk", (hkv * hd,), ("zeros",)),
                      (f"{pre}/attn/bv", (hkv * hd,), ("zeros",))]
        specs.append((f"{pre}/norm2/scale", (E,), ("ones",)))
        if cfg.activation == "swiglu":
            specs.append((f"{pre}/mlp/w_gate", (E, F), dense(E)))
        specs += [(f"{pre}/mlp/w_up", (E, F), dense(E)),
                  (f"{pre}/mlp/w_down", (F, E), dense(F, out_scale))]
    specs.append(("final_norm/scale", (E,), ("ones",)))
    return specs


def leaf_dtype(path: str, dtype: torch.dtype) -> torch.dtype:
    """Norm scales stay f32 (the reference reads them as f32); the rest
    are stored in the compute dtype."""
    return torch.float32 if path.endswith("/scale") else dtype


def assemble(cfg: ArchConfig, flat: Mapping[str, torch.Tensor]) -> nn.ModuleDict:
    """Build the parameter tree from a flat {path: tensor} mapping."""
    def pdict(prefix: str) -> nn.ParameterDict:
        return nn.ParameterDict({
            path[len(prefix) + 1:]: nn.Parameter(t, requires_grad=False)
            for path, t in flat.items()
            if path.startswith(prefix + "/") and "/" not in path[len(prefix) + 1:]})

    layers = nn.ModuleList()
    for i in range(cfg.num_layers):
        layers.append(nn.ModuleDict({
            name: pdict(f"layers/{i}/{name}")
            for name in ("norm1", "attn", "norm2", "mlp")}))
    return nn.ModuleDict({"embed": pdict("embed"), "layers": layers,
                          "final_norm": pdict("final_norm")})


def init(seed: int, cfg: ArchConfig, device="cuda") -> nn.ModuleDict:
    """Random weights with the reference's distributions, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = L.compute_dtype(cfg)
    flat = {}
    for path, shape, how in param_specs(cfg):
        ldt = leaf_dtype(path, dt)
        if how[0] == "normal":
            flat[path] = L.normal_init(gen, shape, ldt, how[1])
        elif how[0] == "ones":
            flat[path] = torch.ones(shape, dtype=ldt, device=dev)
        else:
            flat[path] = torch.zeros(shape, dtype=ldt, device=dev)
    return assemble(cfg, flat)


def _device_of(params: nn.ModuleDict) -> torch.device:
    return params["embed"]["embedding"].device


def forward(params: nn.ModuleDict, cfg: ArchConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux). ``aux`` is the reference's
    MoE load-balance loss, always 0 for the dense family."""
    check_ported(cfg)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for lp in params["layers"]:
        h = L.attention_block(lp["attn"], cfg,
                              L.rmsnorm(x, lp["norm1"]["scale"], cfg.norm_eps),
                              positions=positions)
        x = x + h
        h2 = L.mlp_block(lp["mlp"], cfg,
                         L.rmsnorm(x, lp["norm2"]["scale"], cfg.norm_eps))
        x = x + h2
    x = L.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return L.logits(params["embed"], cfg, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_cache(params: nn.ModuleDict, cfg: ArchConfig, batch: int,
               max_len: int, dtype: torch.dtype,
               aux: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    check_ported(cfg)
    dev = _device_of(params)
    smax = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, smax, hkv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def decode_step(params: nn.ModuleDict, cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                aux: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens (B, 1) -> logits (B, 1, V); advances the KV cache one position.

    The K/V tensors of ``cache`` are written in place and returned in the
    new cache dict together with ``pos + 1``.
    """
    check_ported(cfg)
    x = L.embed(params["embed"], cfg, tokens)
    pos = cache["pos"]
    for i, lp in enumerate(params["layers"]):
        h, _, _ = L.attention_decode(
            lp["attn"], cfg, L.rmsnorm(x, lp["norm1"]["scale"], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos)
        x = x + h
        h2 = L.mlp_block(lp["mlp"], cfg,
                         L.rmsnorm(x, lp["norm2"]["scale"], cfg.norm_eps))
        x = x + h2
    x = L.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    out = dict(cache, pos=pos + 1)
    return L.logits(params["embed"], cfg, x), out
