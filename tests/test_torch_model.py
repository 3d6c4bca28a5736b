"""The port's config, weight bridge, layers and model against the reference.

Reduced deepseek-7b (2 layers, d_model 64, 4 query heads over 2 KV heads,
head_dim 16, f32) on the CPU. Weights are the reference's own, carried
over by ``params_from_jax``; activations come from a seeded numpy
generator. Tolerances: 2e-5 for the norm, RoPE and MLP, 1e-4 for the
attention block, decode step and whole-model logits (more f32 sums in a
different order).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core.hetero_dp import make_prefill_step as ref_make_prefill_step
from repro.models import layers as ref_L
from repro.models.model_factory import build_model as ref_build_model
from repro_torch.configs import base
from repro_torch.core.hetero_dp import make_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model_factory import aux_inputs, build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "deepseek-7b"


def cfgs(**overrides):
    ref = ref_base.reduced_config(ref_base.get_arch(ARCH), **overrides)
    port = base.reduced_config(base.get_arch(ARCH), **overrides)
    return ref, port


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in np_tree(tree).items()}


def rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def ref_model():
    rcfg, cfg = cfgs()
    model = ref_build_model(rcfg)
    return rcfg, cfg, model, model.init(jax.random.PRNGKey(0))


class TestConfig:
    @pytest.mark.parametrize("reduced", [False, True])
    def test_matches_reference(self, reduced):
        ref, port = ref_base.get_arch(ARCH), base.get_arch(ARCH)
        if reduced:
            ref, port = ref_base.reduced_config(ref), base.reduced_config(port)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.resolved_head_dim == ref.resolved_head_dim

    def test_unported_arch_raises(self):
        assert base.list_archs() == [ARCH]
        with pytest.raises(KeyError, match="not ported"):
            base.get_arch("mamba2-1.3b")

    def test_unported_families_raise(self):
        _, cfg = cfgs()
        moe = dataclasses.replace(cfg, moe=base.MoEConfig(4, 2, 64))
        vlm = dataclasses.replace(cfg, cross_attn_every=2)
        for bad, match in ((moe, "MoE"), (vlm, "VLM")):
            with pytest.raises(NotImplementedError, match=match):
                build_model(bad)
        with pytest.raises(NotImplementedError):
            build_model(dataclasses.replace(cfg, family="ssm"))
        assert aux_inputs(cfg, 2, 8) == {}


class TestBridge:
    def test_every_leaf_consumed_once_with_shapes(self, ref_model):
        rcfg, cfg, _, rp = ref_model
        tree = np_tree(rp)
        params = params_from_jax(tree, cfg, device="cpu")
        port = dict(params.named_parameters())
        n_ref = sum(leaf.shape[0] if path[0].key == "layers" else 1
                    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(port) == n_ref == len(transformer.param_specs(cfg))
        for i in range(cfg.num_layers):
            for group in ("attn", "mlp", "norm1", "norm2"):
                for name, arr in tree["layers"][group].items():
                    got = port[f"layers.{i}.{group}.{name}"]
                    assert tuple(got.shape) == arr.shape[1:]
                    np.testing.assert_array_equal(got.numpy(), arr[i])
        np.testing.assert_array_equal(
            params["embed"]["lm_head"].numpy(), tree["embed"]["lm_head"])
        assert params["final_norm"]["scale"].dtype == torch.float32

    def test_missing_unused_and_misshapen_leaves_raise(self, ref_model):
        _, cfg, _, rp = ref_model
        tree = np_tree(rp)
        missing = dict(tree, embed={"embedding": tree["embed"]["embedding"]})
        with pytest.raises(ValueError, match="missing leaves.*lm_head"):
            params_from_jax(missing, cfg, device="cpu")
        extra = dict(tree, extra={"w": np.zeros(3)})
        with pytest.raises(ValueError, match="unused leaves.*extra/w"):
            params_from_jax(extra, cfg, device="cpu")
        bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
        with pytest.raises(ValueError, match="shape mismatch"):
            params_from_jax(bad, cfg, device="cpu")
        unstacked = dict(tree, layers=dict(
            tree["layers"], norm1={"scale": np.ones(64, np.float32)}))
        with pytest.raises(ValueError, match="leading dim"):
            params_from_jax(unstacked, cfg, device="cpu")

    def test_bf16_load_keeps_norms_f32(self, ref_model):
        _, cfg, _, rp = ref_model
        params = params_from_jax(np_tree(rp), cfg, device="cpu",
                                 dtype=torch.bfloat16)
        assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
        assert params["layers"][0]["norm1"]["scale"].dtype == torch.float32


class TestLayers:
    def test_rmsnorm(self):
        x, s = rand((2, 5, 64)), rand((64,), 1)
        want = ref_L.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5)
        got = L.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("batched", [False, True])
    def test_apply_rope(self, batched):
        x = rand((2, 7, 4, 16))
        pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 30, 31, 32, 33]]) \
            if batched else np.arange(7)
        cos, sin = ref_L.rope_tables(jnp.asarray(pos), 16, 10000.0)
        want = ref_L.apply_rope(jnp.asarray(x), cos, sin)
        tcos, tsin = L.rope_tables(torch.from_numpy(pos), 16, 10000.0)
        np.testing.assert_allclose(tcos.numpy(), cos, rtol=2e-5, atol=2e-5)
        got = L.apply_rope(torch.from_numpy(x), tcos, tsin)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("activation", ["swiglu", "gelu"])
    def test_mlp_block(self, activation):
        rcfg, cfg = cfgs(activation=activation)
        p = ref_L.init_mlp(jax.random.PRNGKey(1), rcfg)
        x = rand((2, 5, 64), 2)
        want = ref_L.mlp_block(p, rcfg, jnp.asarray(x))
        got = L.mlp_block(to_torch(p), cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("qkv_bias", [False, True])
    def test_attention_block(self, qkv_bias):
        rcfg, cfg = cfgs(qkv_bias=qkv_bias)
        p = ref_L.init_attention(jax.random.PRNGKey(2), rcfg)
        if qkv_bias:   # non-zero biases, so the bias add is exercised
            p = dict(p, bq=jnp.asarray(rand((64,), 5)),
                     bk=jnp.asarray(rand((32,), 6)), bv=jnp.asarray(rand((32,), 7)))
        x = rand((2, 24, 64), 3)
        want = ref_L.attention_block(p, rcfg, jnp.asarray(x))
        got = L.attention_block(to_torch(p), cfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("window", [0, 8])
    def test_attention_decode(self, window):
        rcfg, cfg = cfgs(sliding_window=window)
        p = ref_L.init_attention(jax.random.PRNGKey(3), rcfg)
        smax = 8 if window else 12
        x = rand((3, 1, 64), 4)
        kc, vc = rand((3, smax, 2, 16), 5), rand((3, smax, 2, 16), 6)
        pos = np.array([2, 7, 19], np.int32)   # 19 wraps the ring / clamps
        want = ref_L.attention_decode(p, rcfg, jnp.asarray(x), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(pos))
        got = L.attention_decode(to_torch(p), cfg, torch.from_numpy(x),
                                 torch.from_numpy(kc.copy()),
                                 torch.from_numpy(vc.copy()),
                                 torch.from_numpy(pos))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)

    def test_embed_and_tied_logits(self):
        rcfg, cfg = cfgs(tie_embeddings=True)
        p = ref_L.init_embedding(jax.random.PRNGKey(4), rcfg)
        assert "lm_head" not in p
        toks = np.array([[1, 5, 255], [0, 3, 7]], np.int32)
        x = ref_L.embed(p, rcfg, jnp.asarray(toks))
        got = L.embed(to_torch(p), cfg, torch.from_numpy(toks).long())
        np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=0)
        np.testing.assert_allclose(
            L.logits(to_torch(p), cfg, got).numpy(),
            ref_L.logits(p, rcfg, x), rtol=2e-5, atol=2e-5)
        assert L.padded_vocab(cfg) == ref_L.padded_vocab(rcfg) == 256


class TestModel:
    def test_prefill_logits_match_pallas_reference(self, ref_model, monkeypatch):
        rcfg, cfg, rmodel, rp = ref_model
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
        monkeypatch.setenv("REPRO_KERNEL_IMPL", "pallas")   # interpret mode
        want = ref_make_prefill_step(rmodel)(
            rp, {"tokens": jnp.asarray(toks, jnp.int32)})
        params = params_from_jax(np_tree(rp), cfg, device="cpu")
        got = make_prefill_step(build_model(cfg))(
            params, {"tokens": torch.from_numpy(toks)})
        assert got.shape == want.shape == (2, 24, 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    def test_init_distributions_and_aux(self):
        _, cfg = cfgs()
        model = build_model(cfg)
        params = model.init(0, "cpu")
        again = model.init(0, "cpu")
        for (name, a), (_, b) in zip(params.named_parameters(),
                                     again.named_parameters()):
            assert torch.equal(a, b), name
        wq = params["layers"][0]["attn"]["wq"]
        assert wq.dtype == torch.float32 and not wq.requires_grad
        assert abs(wq.std().item() - 64 ** -0.5) < 0.02
        wo = params["layers"][1]["attn"]["wo"]
        assert abs(wo.std().item() - (2 * 2) ** -0.5 * 64 ** -0.5) < 0.01
        assert torch.equal(params["final_norm"]["scale"], torch.ones(64))
        toks = torch.zeros((1, 4), dtype=torch.long)
        logits, aux = model.forward(params, {"tokens": toks})
        assert logits.shape == (1, 4, 256) and float(aux) == 0.0

    def test_cuda_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; the default is usable")
        _, cfg = cfgs()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg).init(0)


class TestIsolation:
    def test_port_imports_no_jax_and_no_reference(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import repro_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(\n"
            "    repro_torch.__path__, 'repro_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.startswith('jax')\n"
            "             or n == 'repro' or n.startswith('repro.'))\n"
            "assert len(mods) >= 12, mods\n"
            "assert not bad, bad\n")
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr

    def test_chip_smoke_imports_no_jax_and_no_reference(self):
        with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module or "")
        roots = {n.split(".")[0] for n in names}
        assert "jax" not in roots and "repro" not in roots, roots
        assert "repro_torch" in roots
