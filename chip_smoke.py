#!/usr/bin/env python3
"""The PyTorch port on one NVIDIA GPU, end to end.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch version at the reference's
test shapes and at deepseek-7b's prefill shapes, then drives the serving
path at full width (30 layers, d_model 4096, bf16, seeded random
weights): ``make_prefill_step`` through the kernel and through the plain
version, and ``Server.generate``. Every phase asserts. The last two lines
are a ``{"kernels": [...]}`` JSON line and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository's ``src/`` beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense), for the bound.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}   # tests/test_kernels.py
# Besides that elementwise tolerance, each output row (one query of one
# head) must agree on average: its mean |kernel - plain| over D, relative
# to its mean |plain|, stays within two roundings of the output dtype. A
# kernel that drops or repeats one KV tile for some rows moves those rows
# by percents, which the elementwise tolerance could let through.
ROW_REL_TOL = {"torch.float32": 2.0 ** -14, "torch.bfloat16": 2.0 ** -6}
PREFILL_BATCH, PREFILL_SEQ = 2, 1024
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 32, 16
# Max |kernel - plain| over full-width logits, relative to max |logits|:
# both paths run f32 attention on bf16 inputs and round to bf16, so they
# differ by bf16 roundings (2^-8 relative) that 30 layers carry along.
PREFILL_REL_TOL = 5e-2


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def allowed_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """Query-key pairs the masks leave live: the work this input needs."""
    total = 0
    for qpos in range(sq):
        hi = min(qpos, sk - 1) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def attention_bound(b, sq, sk, hq, hkv, d, dtype, causal, window):
    """(ms, 'bytes' | 'operations'): the least time the card could take."""
    es = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = es * d * (2 * b * hq * sq + 2 * b * hkv * sk)   # q, o; k, v
    flops = 4 * b * hq * d * allowed_pairs(sq, sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel_sweep(fa, torch, F):
    """Kernel against its plain version on the card; returns the row of
    the main path's shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [  # b, s, hq, hkv, d, dtype, causal, window
        (1, 128, 4, 4, 64, f32, True, 0),       # tests/test_kernels.py sweep
        (1, 128, 4, 4, 64, bf16, True, 0),
        (2, 256, 8, 2, 64, f32, True, 0),
        (2, 256, 8, 2, 64, bf16, True, 0),
        (1, 128, 4, 1, 128, f32, True, 0),
        (2, 384, 4, 4, 64, f32, True, 0),
        (1, 256, 4, 4, 64, f32, True, 32),
        (1, 256, 4, 4, 64, f32, True, 100),
        (1, 256, 4, 4, 64, f32, True, 256),
        (2, 128, 4, 4, 64, f32, False, 0),
        (2, 24, 4, 2, 16, f32, True, 0),        # reduced deepseek-7b
        (1, 100, 4, 4, 32, bf16, True, 0),      # head_dim 32, ragged tail
        (PREFILL_BATCH, PREFILL_SEQ, 32, 32, 128, bf16, True, 0),   # main path
        (2, 2048, 32, 32, 128, bf16, True, 0),  # deepseek-7b prefill, S=2048
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_row = None
    for b, s, hq, hkv, d, dt, causal, window in shapes:
        # the model's (B, S, H, D) tensors, seen as (B, H, S, D) as ops does
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(dt).transpose(1, 2) for h in (hq, hkv, hkv))
        kw = dict(causal=causal, sliding_window=window)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, **kw)
        assert got.dtype == want.dtype == dt and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        tol = TOL[str(dt)]
        max_err = diff.max().item()
        assert bool((diff <= tol + tol * want.float().abs()).all()), \
            f"kernel != plain at {(b, s, hq, hkv, d, dt, causal, window)}: {max_err}"
        row_err = (diff.mean(-1) / want.float().abs().mean(-1).clamp_min(1e-30)
                   ).max().item()
        assert row_err <= ROW_REL_TOL[str(dt)], \
            f"rows disagree at {(b, s, hq, hkv, d, dt, causal, window)}: {row_err}"
        ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=20)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                           iters=10, warmup=1)
        lib_ms = None
        if not window:
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv), iters=20)
        bound_ms, bound_by = attention_bound(b, s, s, hq, hkv, d, dt, causal, window)
        row = dict(shape=dict(b=b, s=s, hq=hq, hkv=hkv, d=d, dtype=str(dt),
                              causal=causal, window=window),
                   max_abs_err=max_err, max_row_rel_err=row_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        log("sweep", json.dumps(row))
        if (b, s, d, dt) == (PREFILL_BATCH, PREFILL_SEQ, 128, bf16):
            main_row = row
    return main_row


def phase_prefill(cfg, model, params, fa, ops, torch, make_prefill_step):
    """Full-width prefill through the kernel, then through the plain version."""
    prefill = make_prefill_step(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    prefill(params, batch)                      # warm-up: cuBLAS set-up
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fa.LAUNCHES
    assert launches == cfg.num_layers, (launches, cfg.num_layers)
    with ops.forced_impl("plain"):
        t0 = time.perf_counter()
        plain = prefill(params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    assert fa.LAUNCHES == launches, "the plain path launched the kernel"
    vp = logits.shape[-1]
    assert logits.shape == (PREFILL_BATCH, PREFILL_SEQ, vp) and logits.dtype == torch.bfloat16
    lg, pl = logits.float(), plain.float()
    assert bool(torch.isfinite(lg).all()) and bool(torch.isfinite(pl).all())
    max_diff = (lg - pl).abs().max().item()
    scale = pl.abs().max().item()
    agree = (lg[..., :cfg.vocab_size].argmax(-1)
             == pl[..., :cfg.vocab_size].argmax(-1)).float().mean().item()
    log(f"prefill B={PREFILL_BATCH} S={PREFILL_SEQ}: kernel {prefill_s:.4f} s, "
        f"plain {plain_s:.4f} s, launches {launches}, max |logit diff| "
        f"{max_diff:.4g} (max |logit| {scale:.4g}, tol {PREFILL_REL_TOL} rel), "
        f"argmax agreement {agree:.4f}")
    assert max_diff <= PREFILL_REL_TOL * scale, (max_diff, scale)
    return dict(launches=launches, prefill_s=prefill_s, plain_prefill_s=plain_s,
                max_abs_diff=max_diff, max_abs_logit=scale, argmax_agree=agree)


def phase_serve(cfg, model, params, np, torch, Server, make_prefill_step):
    """Full-width Server: deterministic greedy tokens; prefill vs decode path."""
    srv = Server(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN + 1,
                 device="cuda", params=params)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
    out1 = srv.generate(prompts, SERVE_GEN)
    out2 = srv.generate(prompts, SERVE_GEN)
    toks = out2["tokens"]
    assert toks.shape == (SERVE_BATCH, SERVE_GEN), toks.shape
    assert (out1["tokens"] == toks).all(), "generation is not deterministic"
    assert (toks >= 0).all() and (toks < cfg.vocab_size).all()
    st = out2["stats"]
    _, dec_logits = srv.prefill(prompts)
    full = make_prefill_step(model)(
        params, {"tokens": torch.as_tensor(prompts, device="cuda")})
    a, b = dec_logits[:, 0].float(), full[:, -1].float()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    diff = (a - b).abs().max().item()
    agree = (a[:, :cfg.vocab_size].argmax(-1)
             == b[:, :cfg.vocab_size].argmax(-1)).float().mean().item()
    log(f"serve B={SERVE_BATCH} prompt={SERVE_PROMPT} gen={SERVE_GEN}: "
        f"prefill_s {st.prefill_s:.4f} decode_s {st.decode_s:.4f} "
        f"tok/s {st.tokens_per_s:.2f}; prefill-step vs decode-path last logits "
        f"max |diff| {diff:.4g} (max |logit| {b.abs().max().item():.4g}), "
        f"argmax agreement {agree:.4f}")
    log("sample row:", toks[0].tolist())
    return dict(prefill_s=st.prefill_s, decode_s=st.decode_s,
                tokens_per_s=st.tokens_per_s, prefill_vs_decode_max_diff=diff)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.base import get_arch
    from repro_torch.core.hetero_dp import make_prefill_step
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Server
    from repro_torch.models.model_factory import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build(fa.KERNEL)
    log(f"built {fa.KERNEL} in {time.perf_counter() - t0:.1f} s")
    log(_build.build_log(fa.KERNEL).strip())

    main_row = phase_kernel_sweep(fa, torch, F)

    cfg = get_arch("deepseek-7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"deepseek-7b full width: {cfg.num_layers} layers, {n_params} params, "
        f"init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    pre = phase_prefill(cfg, model, params, fa, ops, torch, make_prefill_step)
    phase_serve(cfg, model, params, np, torch, Server, make_prefill_step)

    kernels = [dict(
        name=fa.KERNEL, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:121",
        launches=pre["launches"], checked=True,
        max_abs_err=main_row["max_abs_err"], ms=main_row["ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        shape=main_row["shape"])]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
