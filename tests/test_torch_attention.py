"""K1 (ops/attention.py) in the PyTorch port.

The plain version against the JAX Pallas kernel ``self_attention_fused``
run in interpret mode, at the shapes of tests/test_attention.py, within
2e-6 (f32; only the summation order differs), and the wrapper's CPU
dispatch. The CUDA kernel itself is held against the plain version in
tests/test_torch_attention_cuda.py.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import mere_fusion_tpu.ops.attention as jax_attention
from mere_fusion_tpu_torch.ops import attention


@pytest.fixture()
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(jax_attention.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("shape,block_q", [
    ((2, 8, 1024, 40), 512),   # the 32² SD latent self-attn
    ((2, 8, 256, 80), 256),    # the 16² one
    ((1, 4, 512, 64), 128),    # multiple q blocks per row
])
def test_plain_matches_jax_fused(interpret_pallas, shape, block_q):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax_attention.self_attention_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block_q))
    out = attention.self_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=2e-6)


def test_cpu_wrapper_uses_plain_and_counts_nothing():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 40)).astype(np.float32))
               for _ in range(3))
    before = attention.launches
    out = attention.self_attention(q, k, v)
    assert attention.launches == before
    torch.testing.assert_close(out, attention.self_attention_plain(q, k, v),
                               rtol=0, atol=0)


def test_kernel_launcher_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 64, 40)
    with pytest.raises(ValueError, match="CUDA"):
        attention.self_attention_cuda(q, q, q)


def test_plain_bf16_casts_probabilities_before_pv():
    """Scores and softmax run in f32; p is rounded to v's dtype before p·v,
    as the JAX einsum path does."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 1, 64, 8)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = attention.self_attention_plain(q, k, v)
    s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(8)
    ref = torch.softmax(s, dim=-1).to(torch.bfloat16) @ v
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
