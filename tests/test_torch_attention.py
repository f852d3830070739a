"""K1 (ops/attention.py) in the PyTorch port.

The plain version against the JAX Pallas kernel ``self_attention_fused``
run in interpret mode, at the shapes of tests/test_attention.py, within
2e-6 (f32; only the summation order differs), and the wrapper's CPU
dispatch. A plain-torch model of the bf16 CUDA kernel's order of operations
(64-key tiles, running max and sum in f32, P rounded to bf16 unnormalised,
one division at the end) against the JAX kernel and the plain version
within the bf16 limit of 1e-2. A model of the f32 kernel's 3xTF32 order
(each operand split into two TF32 terms, three TF32 products per term, 64-key
tiles with an f32 online softmax) against the JAX kernel and the plain
version within the f32 limit of 1e-5, which the same model with single TF32
products fails. The CUDA kernel itself is held against the plain version in
tests/test_torch_attention_cuda.py.
"""
from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import mere_fusion_tpu.ops.attention as jax_attention
from mere_fusion_tpu_torch.ops import attention
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


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


def bf16_kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sum_of_rounded: bool) -> torch.Tensor:
    """The bf16 K1's arithmetic in its order: f32 scores of one 64-key tile
    at a time; a running row max (raw scores) and row sum in f32; p =
    exp2(s·c − m·c) with c = log2(e)/√d, rounded to bf16 *unnormalised*
    before P·V (f32 accumulate); the output and the sum rescaled by
    exp2((m_old − m_new)·c) when the max moves; one division at the end. At
    D = 40 the kernel sums the bf16 P on the tensor cores (V's column 40 is
    1.0): ``sum_of_rounded``; at other D it sums the f32 p."""
    c = math.log2(math.e) / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    den = torch.zeros(q.shape[:-1])
    acc = torch.zeros(qf.shape)
    for k0 in range(0, k.shape[2], attention.BLOCK):
        s = qf @ kf[:, :, k0:k0 + attention.BLOCK].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        pb = p.to(torch.bfloat16).float()
        den = den * alpha + (pb if sum_of_rounded else p).sum(-1)
        acc = acc * alpha[..., None] + pb @ vf[:, :, k0:k0 + attention.BLOCK]
        m = m_new
    return (acc / den[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("sum_of_rounded", [True, False], ids=["sum_bf16_p", "sum_f32_p"])
def test_bf16_kernel_order_within_tolerance(interpret_pallas, sum_of_rounded):
    """The redesigned kernel rounds p before normalising, where the JAX
    kernel and the plain version round the normalised p: at the serving
    head_dim and length the difference stays inside the bf16 limit."""
    rng = np.random.default_rng(3)
    shape = (2, 8, 1024, 40)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    out = bf16_kernel_model(q, k, v, sum_of_rounded).float()
    jax_ref = np.asarray(jax_attention.self_attention_fused(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)),
        block_q=512).astype(jnp.float32))
    plain = attention.self_attention_plain(q, k, v).float()
    err_jax = float(np.abs(out.numpy() - jax_ref).max())
    err_plain = (out - plain).abs().max().item()
    print(f"bf16 kernel model ({'bf16' if sum_of_rounded else 'f32'} p summed): "
          f"max abs err {err_jax:.3e} against the JAX kernel, {err_plain:.3e} against "
          f"the plain version")
    assert err_jax <= 1e-2
    assert err_plain <= 1e-2


@pytest.mark.parametrize("case", ["head_dim_36", "misaligned"])
def test_kernel_launcher_refuses_what_tma_cannot_read(case):
    """bf16 rows reach the kernel by TMA: a head_dim that is a multiple of 8
    (16-byte row strides) and 16-byte aligned tensors. The launcher checks
    these before the device, so the refusal shows on the CPU too."""
    if case == "head_dim_36":
        t = torch.zeros(1, 1, 64, 36, dtype=torch.bfloat16)
        match = "multiple of 8"
    else:
        t = torch.zeros(64 * 40 + 1, dtype=torch.bfloat16)[1:].view(1, 1, 64, 40)
        match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        attention.self_attention_cuda(t, t, t)
    # float32 keeps the CUDA-core kernel, which reads any head_dim up to 128
    with pytest.raises(ValueError, match="CUDA"):
        f = torch.zeros(1, 1, 64, 36)
        attention.self_attention_cuda(f, f, f)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: the f32 mantissa to
    10 bits, ties away from zero (the 13 low bits of the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the f32 kernel's mma.sync steps take it: with terms = 3,
    a_lo b_hi + a_hi b_lo + a_hi b_hi over a = a_hi + a_lo (both TF32; the
    products exact in f32, the sums in f32); with terms = 1, a_hi b_hi."""
    ah, bh = tf32(a), tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def tf32_kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      terms: int) -> torch.Tensor:
    """The f32 K1's arithmetic in its order: S of one 64-key tile at a time
    by tf32_matmul; a running row max (raw scores) and row sum in f32; p =
    exp2(s·c − m·c) with c = log2(e)/√d; O and the sum rescaled by
    exp2((m_old − m_new)·c); O += P V by tf32_matmul; one division at the
    end."""
    c = math.log2(math.e) / math.sqrt(q.shape[-1])
    m = torch.full(q.shape[:-1], -math.inf)
    den = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], attention.BLOCK):
        s = tf32_matmul(q, k[:, :, k0:k0 + attention.BLOCK].transpose(-1, -2), terms)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[..., None])
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + tf32_matmul(p, v[:, :, k0:k0 + attention.BLOCK], terms)
        m = m_new
    return acc / den[..., None]


@pytest.fixture(scope="module")
def f32_serving_case():
    """(q, k, v) f32 at (2, 8, 1024, 40) and the JAX kernel's output in
    interpret mode on them, computed once for the cases below."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 8, 1024, 40)).astype(np.float32) for _ in range(3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention.pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        ref = np.asarray(jax_attention.self_attention_fused(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=512))
    return tuple(torch.from_numpy(a) for a in (q, k, v)), ref


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "single_tf32"])
def test_f32_kernel_order_within_tolerance(f32_serving_case, terms):
    """The three-term split holds the f32 limit of 1e-5 against the JAX
    kernel and the plain version; single TF32 products do not, so the limit
    tells the two apart."""
    (q, k, v), jax_ref = f32_serving_case
    out = tf32_kernel_model(q, k, v, terms)
    err_jax = float(np.abs(out.numpy() - jax_ref).max())
    err_plain = (out - attention.self_attention_plain(q, k, v)).abs().max().item()
    print(f"f32 kernel model, {terms} TF32 product(s) a term: max abs err {err_jax:.3e} "
          f"against the JAX kernel, {err_plain:.3e} against the plain version")
    if terms == 3:
        assert err_jax <= 1e-5 and err_plain <= 1e-5
    else:
        assert err_jax > 1e-5 and err_plain > 1e-5
