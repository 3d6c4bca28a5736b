"""The port on the card: tests that need an NVIDIA GPU with nvcc.

Every test here carries the ``gpu`` marker and skips on a machine without
CUDA. This file imports neither JAX nor the reference package, so it runs
where only the port is installed:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

The CPU parity tests against the reference are the other
``tests/test_torch_*.py`` files.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, reduced_config
from repro_torch.core.hetero_dp import make_prefill_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch.serve import Server
from repro_torch.models.model_factory import build_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0)])
def test_kernel_matches_plain(cuda, dtype, tol, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 200, h, 64), generator=gen, device=cuda)
               .to(dtype).transpose(1, 2) for h in (8, 2, 2))   # GQA 4:1
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_card_path_raises_instead_of_falling_back(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.attention(q, q, q, q_offset=1)


def test_reduced_model_on_card_matches_cpu(cuda):
    cfg = reduced_config(get_arch("deepseek-7b"))
    params = build_model(cfg).init(0, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    cpu = Server(cfg, 2, 24, device="cpu", params=params)
    gpu = Server(cfg, 2, 24, device=cuda, params=copy.deepcopy(params).to(cuda))
    _, lc = cpu.prefill(prompts)
    _, lg = gpu.prefill(prompts)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(gpu.generate(prompts, 8)["tokens"],
                                  cpu.generate(prompts, 8)["tokens"])


def test_reduced_prefill_through_kernel_matches_cpu(cuda):
    cfg = reduced_config(get_arch("deepseek-7b"))
    model = build_model(cfg)
    params = model.init(0, "cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)))
    want = make_prefill_step(model)(params, {"tokens": tokens})
    prefill = make_prefill_step(model)
    before = fa.LAUNCHES
    got = prefill(copy.deepcopy(params).to(cuda), {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
