"""The port's attention against the reference's, on the CPU.

Inputs come from a seeded numpy generator and go to both packages as the
same arrays (bf16 inputs: the same f32 arrays rounded to bf16 by each
framework, both round-to-nearest-even). The reference's Pallas kernel
runs in interpret mode, as tests/test_kernels.py runs it. Tolerances are
those of tests/test_kernels.py: 2e-5 for f32, 2e-2 for bf16.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_fa
from repro.kernels import ops as ref_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

F32, BF16 = "float32", "bfloat16"
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == BF16 \
        else dict(rtol=2e-5, atol=2e-5)


def arrays(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def both(xs, dtype=F32):
    """The same numpy arrays as JAX and as torch tensors of ``dtype``."""
    return ([jnp.asarray(x).astype(JDT[dtype]) for x in xs],
            [torch.from_numpy(x).to(TDT[dtype]) for x in xs])


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


class TestFlashPlainVsPallas:
    """flash_attention_plain (B, H, S, D) vs the Pallas kernel, interpret."""

    @pytest.mark.parametrize("b,s,hq,hkv,d,dtype", [
        (1, 128, 4, 4, 64, F32),      # MHA
        (1, 128, 4, 4, 64, BF16),     # MHA, storage dtype
        (2, 128, 8, 2, 64, F32),      # GQA 4:1
        (2, 128, 8, 2, 64, BF16),
        (1, 128, 4, 1, 128, F32),     # MQA, wide head
        (1, 64, 4, 1, 64, F32),       # MQA
        (2, 200, 4, 4, 64, F32),      # seq not a block multiple
        (2, 24, 4, 2, 16, F32),       # reduced deepseek-7b
    ])
    def test_causal_shapes_dtypes(self, b, s, hq, hkv, d, dtype):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)]), dtype)
        want = ref_fa.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                      block_k=128, interpret=True)
        got = fa.flash_attention_plain(tq, tk, tv, causal=True, block_q=64,
                                       block_k=128)
        assert got.dtype == TDT[dtype] and got.shape == (b, hq, s, d)
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(dtype))

    @pytest.mark.parametrize("window", [32, 100])
    def test_sliding_window(self, window):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(1, 4, 256, 64)] * 3, seed=1))
        want = ref_fa.flash_attention(jq, jk, jv, causal=True,
                                      sliding_window=window, interpret=True)
        got = fa.flash_attention_plain(tq, tk, tv, causal=True,
                                       sliding_window=window)
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))

    def test_noncausal(self):
        (jq, jk, jv), (tq, tk, tv) = both(arrays([(2, 4, 128, 64)] * 3, seed=2))
        want = ref_fa.flash_attention(jq, jk, jv, causal=False, interpret=True)
        got = fa.flash_attention_plain(tq, tk, tv, causal=False)
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))

    def test_block_shape_independence(self):
        _, (tq, tk, tv) = both(arrays([(1, 4, 256, 32)] * 3, seed=3))
        outs = [fa.flash_attention_plain(tq, tk, tv, block_q=bq, block_k=bk)
                for bq, bk in [(128, 128), (64, 256), (256, 32)]]
        for o in outs[1:]:
            np.testing.assert_allclose(as_np(o), as_np(outs[0]),
                                       rtol=1e-5, atol=1e-5)

    def test_fully_masked_row_is_zero(self):
        # non-causal window with Sq > Sk: queries past Sk + window see no key
        _, (tq, tk, tv) = both(arrays([(1, 2, 96, 16), (1, 2, 32, 16),
                                       (1, 2, 32, 16)], seed=4))
        out = fa.flash_attention_plain(tq, tk, tv, causal=False,
                                       sliding_window=16, block_q=32,
                                       block_k=32)
        assert torch.all(out[:, :, 47:] == 0)
        assert torch.all(out[:, :, :47].abs().sum(-1) > 0)


class TestOpsAttention:
    def test_default_on_cpu_is_plain_flash_and_never_launches(self):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)], seed=5))
        fa.reset_launches()
        got = ops.attention(tq, tk, tv, causal=True)
        want = ref_ops.attention(jq, jk, jv, causal=True, impl="pallas")
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))
        assert fa.LAUNCHES == 0

    @pytest.mark.parametrize("sq,sk", [(64, 64), (64, 192), (1, 333)])
    @pytest.mark.parametrize("impl", ["blocked", "naive"])
    def test_rectangular_and_offset(self, sq, sk, impl):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(2, sq, 4, 32), (2, sk, 2, 32), (2, sk, 2, 32)], seed=6))
        off = sk - sq
        got = ops.attention(tq, tk, tv, causal=True, q_offset=off, impl=impl,
                            block_k=128)
        want = ref_ops.attention(jq, jk, jv, causal=True, q_offset=off,
                                 impl="naive")
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))

    @pytest.mark.parametrize("impl", ["blocked", "naive"])
    def test_kv_mask(self, impl):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(2, 32, 4, 32), (2, 64, 4, 32), (2, 64, 4, 32)], seed=7))
        mask = np.arange(64)[None, :] < np.array([40, 64])[:, None]
        got = ops.attention(tq, tk, tv, causal=False,
                            kv_mask=torch.from_numpy(mask), impl=impl,
                            block_k=48)
        want = ref_ops.attention(jq, jk, jv, causal=False,
                                 kv_mask=jnp.asarray(mask), impl="naive")
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))

    def test_mask_or_offset_without_impl_raises(self):
        _, (tq, tk, tv) = both(arrays([(1, 8, 2, 16)] * 3))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.attention(tq, tk, tv, q_offset=3)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.attention(tq, tk, tv, kv_mask=torch.ones(1, 8))

    def test_forced_impl_scopes_the_default(self):
        _, (tq, tk, tv) = both(arrays([(1, 8, 2, 16)] * 3))
        with ops.forced_impl("naive"):
            got = ops.attention(tq, tk, tv, q_offset=2)
        want = ops.attention(tq, tk, tv, q_offset=2, impl="naive")
        assert torch.equal(got, want)
        with pytest.raises(NotImplementedError):
            ops.attention(tq, tk, tv, q_offset=2)
        with pytest.raises(ValueError):
            ops.forced_impl("pallas").__enter__()

    def test_decode_attention(self):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(3, 1, 8, 32), (3, 96, 2, 32), (3, 96, 2, 32)], seed=8))
        pos = np.array([10, 50, 95])
        got = ops.decode_attention(tq, tk, tv, q_offset=torch.from_numpy(pos))
        want = ref_ops.decode_attention(jq, jk, jv, q_offset=jnp.asarray(pos))
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(F32))

    def test_decode_attention_kv_mask_bf16(self):
        (jq, jk, jv), (tq, tk, tv) = both(
            arrays([(2, 1, 4, 16), (2, 24, 2, 16), (2, 24, 2, 16)], seed=9),
            BF16)
        pos = np.array([23, 23])
        mask = np.arange(24)[None, :] >= np.array([0, 8])[:, None]
        got = ops.decode_attention(tq, tk, tv, q_offset=torch.from_numpy(pos),
                                   kv_mask=torch.from_numpy(mask))
        want = ref_ops.decode_attention(jq, jk, jv, q_offset=jnp.asarray(pos),
                                        kv_mask=jnp.asarray(mask))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(as_np(got), as_np(want), **tol(BF16))


class TestKernelWrapper:
    @pytest.mark.parametrize("d", [8, 48, 256])
    def test_unsupported_head_dim_raises(self, d):
        q = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match="head_dim"):
            fa.check_kernel_inputs(q, q, q)

    def test_mixed_dtypes_and_strided_head_dim_raise(self):
        q = torch.zeros(1, 2, 8, 64)
        with pytest.raises(ValueError, match="dtypes"):
            fa.check_kernel_inputs(q, q.bfloat16(), q)
        strided = torch.zeros(1, 2, 8, 128)[..., ::2]
        with pytest.raises(ValueError, match="contiguous"):
            fa.check_kernel_inputs(strided, strided, strided)

    def test_model_layout_views_are_accepted(self):
        q = torch.zeros(2, 24, 4, 16).transpose(1, 2)   # (B,S,H,D) as (B,H,S,D)
        fa.check_kernel_inputs(q, q[:, :2], q[:, :2])
