"""Where the serving path's device time goes, from a ``torch.profiler`` trace.

  PYTHONPATH=src python -m repro_torch.launch.profile

Full-width deepseek-7b with seeded random weights, at the shapes of
``chip_smoke.py``. After a warm-up, profiles one ``make_prefill_step``
call (B=2, S=1024) and 4 decode steps of a ``Server`` batch of 4 after a
32-token prompt, each on its own.
For each it prints the host wall time (synchronised), the device busy
time (the union of kernel intervals in the trace), the device idle share
of the wall time, the device time by kernel class (the flash-attention
kernel, matrix products, everything else) and the top kernels, then one
JSON line with the same numbers. The traces go to ``build/profile/``.
It needs the card: device time exists only there.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_arch
from repro_torch.core.hetero_dp import make_prefill_step, make_serve_step
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Server
from repro_torch.models.model_factory import build_model

TRACE_DIR = Path(__file__).resolve().parents[3] / "build" / "profile"
MATMUL_MARKS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "matmul")
PREFILL_BATCH, PREFILL_SEQ = 2, 1024
SERVE_BATCH, SERVE_PROMPT, DECODE_STEPS = 4, 32, 4
SEED = 0


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd"
    if any(m in low for m in MATMUL_MARKS):
        return "matmul"
    return "other"


def _union_us(spans: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_region(name: str, fn: Callable[[], None]) -> Dict[str, object]:
    """Profile one call of ``fn`` (which must end synchronised)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_class: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e["name"])] += e["dur"] / 1e3
        by_name[e["name"]] += e["dur"] / 1e3
    busy_ms = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in kernels]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"region": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(kernels), "device_ms_by_class": dict(by_class),
            "top_kernels_ms": [[n[:90], t] for n, t in top],
            "trace": str(path)}


def main() -> None:
    dev = resolve_device("cuda")
    cfg = get_arch("deepseek-7b")
    model = build_model(cfg)
    params = model.init(SEED, dev)
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_SEQ)), device=dev)}

    srv = Server(cfg, SERVE_BATCH, SERVE_PROMPT + DECODE_STEPS + 1,
                 device=dev, params=params)
    cache, logits = srv.prefill(
        rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)))
    tok = logits.argmax(-1)

    def run_prefill():
        prefill(params, batch)

    def run_decode():
        nonlocal cache, tok
        for _ in range(DECODE_STEPS):
            logits_, cache = serve(params, cache, tok)
            tok = logits_.argmax(-1)

    run_prefill()                       # warm-up: cuBLAS and the kernel build
    torch.cuda.synchronize()
    out = [profile_region("prefill", run_prefill)]
    snapshot = {k: v.clone() for k, v in cache.items()}
    run_decode()                        # warm-up of the decode shapes
    cache = snapshot
    out.append(profile_region("decode", run_decode))
    for r in out:
        print(f"{r['region']}: wall {r['wall_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms, idle share "
              f"{r['device_idle_share']:.4f}, {r['kernels']} kernels")
        for cls, ms in sorted(r["device_ms_by_class"].items(), key=lambda kv: -kv[1]):
            print(f"  {cls:22s} {ms:10.3f} ms")
        for n, ms in r["top_kernels_ms"]:
            print(f"    {ms:10.3f} ms  {n}")
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "arch": cfg.name, "prefill": [PREFILL_BATCH, PREFILL_SEQ],
                      "decode": [SERVE_BATCH, DECODE_STEPS], "regions": out}))


if __name__ == "__main__":
    main()
