"""Batched serving loop; port of ``repro/launch/serve.py`` (dense family).

A fixed-capacity request batch: token-by-token prefill through the decode
step, then greedy generation. The KV cache is held in f32 whatever the
compute dtype, as in the reference.

CLI (on the card by default):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --full-size --batch 4 --prompt-len 16 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, get_arch, reduced_config
from repro_torch.core.hetero_dp import make_serve_step
from repro_torch.device import resolve_device
from repro_torch.models.model_factory import aux_inputs, build_model


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_out: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(self.decode_s, 1e-9)


class Server:
    """Fixed-capacity batched decoder.

    ``params`` (optional) serves given weights, e.g. ones carried over
    from the reference by ``models.bridge``; otherwise they are drawn
    from ``seed``.
    """

    def __init__(self, arch_cfg: ArchConfig, batch: int, max_len: int,
                 seed: int = 0, device="cuda",
                 params: Optional[nn.ModuleDict] = None):
        self.device = resolve_device(device)
        self.cfg = arch_cfg
        self.batch = batch
        self.max_len = max_len
        self.model = build_model(arch_cfg)
        self.params = params if params is not None else \
            self.model.init(seed, self.device)
        self.aux = aux_inputs(arch_cfg, batch, max_len) or None
        self._decode = make_serve_step(self.model)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, prompts: np.ndarray):
        """Teacher-forced prefill via decode steps (cache warm-up)."""
        cache = self.model.init_cache(self.params, self.batch, self.max_len,
                                      torch.float32, self.aux)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        logits = None
        for t in range(toks.shape[1]):
            logits, cache = self._decode(self.params, cache,
                                         toks[:, t:t + 1], self.aux)
        return cache, logits

    def generate(self, prompts: np.ndarray, steps: int) -> Dict[str, Any]:
        """Greedy decoding of ``steps`` tokens after the prompts."""
        t0 = time.perf_counter()
        cache, logits = self.prefill(prompts)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = logits[:, :, :self.cfg.vocab_size].argmax(dim=-1)
        for _ in range(steps):
            out.append(tok)
            logits, cache = self._decode(self.params, cache, tok, self.aux)
            tok = logits[:, :, :self.cfg.vocab_size].argmax(dim=-1)
        self._sync()
        t2 = time.perf_counter()
        tokens = torch.cat(out, dim=1).cpu().numpy()
        return {"tokens": tokens,
                "stats": ServeStats(t1 - t0, t2 - t1, int(tokens.size))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    arch = get_arch(args.arch)
    if not args.full_size:
        arch = reduced_config(arch)
    server = Server(arch, args.batch, args.prompt_len + args.gen + 1,
                    device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, arch.vocab_size, (args.batch, args.prompt_len))
    out = server.generate(prompts, args.gen)
    s = out["stats"]
    print(f"arch={args.arch} batch={args.batch} device={server.device} "
          f"prefill {s.prefill_s:.2f}s decode {s.decode_s:.2f}s "
          f"-> {s.tokens_per_s:.1f} tok/s")
    print("sample row:", out["tokens"][0, :16])


if __name__ == "__main__":
    main()
