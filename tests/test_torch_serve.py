"""The port's Server against the reference's, on the CPU.

Reduced deepseek-7b (f32); the port serves the reference Server's own
weights through ``params_from_jax``. Greedy tokens must be identical and
the logits of every step agree within 1e-4.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import reduced_config as ref_reduced_config
from repro.launch.serve import Server as RefServer
from repro_torch.configs.base import get_arch, reduced_config
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models.bridge import params_from_jax

ARCH = "deepseek-7b"
BATCH, MAX_LEN, PROMPT, STEPS = 2, 24, 6, 8


@pytest.fixture(scope="module")
def servers():
    rcfg = ref_reduced_config(ref_get_arch(ARCH))
    cfg = reduced_config(get_arch(ARCH))
    ref = RefServer(rcfg, batch=BATCH, max_len=MAX_LEN, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params), cfg,
                             device="cpu")
    port = Server(cfg, BATCH, MAX_LEN, device="cpu", params=params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (BATCH, PROMPT))
    return ref, port, prompts


def test_generate_tokens_identical_to_reference(servers):
    ref, port, prompts = servers
    want = ref.generate(prompts, STEPS)["tokens"]
    out = port.generate(prompts, STEPS)
    assert out["tokens"].shape == (BATCH, STEPS)
    np.testing.assert_array_equal(out["tokens"], want)
    st = out["stats"]
    assert st.tokens_out == BATCH * STEPS and st.tokens_per_s > 0


def test_per_step_logits_match_reference(servers):
    ref, port, prompts = servers
    rcache, rlogits = ref.prefill(prompts)
    cache, logits = port.prefill(prompts)
    assert tuple(logits.shape) == rlogits.shape == (BATCH, 1, 256)
    assert cache["k"].dtype == torch.float32          # f32 cache, as serve.py:61
    np.testing.assert_array_equal(cache["pos"].numpy(), rcache["pos"])
    for step in range(STEPS):
        np.testing.assert_allclose(logits.numpy(), rlogits, rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        tok = jnp.argmax(rlogits[:, :, :ref.cfg.vocab_size], axis=-1)
        rlogits, rcache = ref._decode(ref.params, rcache, tok, ref.aux)
        logits, cache = port._decode(port.params, cache,
                                     torch.from_numpy(np.array(tok)).long())
    np.testing.assert_allclose(cache["k"].numpy(), rcache["k"], rtol=1e-4,
                               atol=1e-4)


def test_generate_deterministic(servers):
    _, port, prompts = servers
    out1 = port.generate(prompts, STEPS)
    out2 = port.generate(prompts, STEPS)
    np.testing.assert_array_equal(out1["tokens"], out2["tokens"])
    assert (out1["tokens"] < port.cfg.vocab_size).all()


def test_seeded_init_is_deterministic():
    cfg = reduced_config(get_arch(ARCH))
    prompts = np.arange(8).reshape(2, 4)
    a = Server(cfg, 2, 12, seed=3, device="cpu").generate(prompts, 4)
    b = Server(cfg, 2, 12, seed=3, device="cpu").generate(prompts, 4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = reduced_config(get_arch(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, 2, 12)


def test_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--batch", "2", "--prompt-len", "4", "--gen", "3",
        "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "arch=deepseek-7b batch=2 device=cpu" in out
    assert "sample row:" in out
