"""K2's head with float32 shade weights as the tensor-core kernel computes it
(csrc/sampler_core.cuh ``head_tf32``), emulated in torch bit operations on
the CPU, against the JAX K2 with float32 weights in interpret mode.

The kernel takes every wide product (x·Wx_aud, x·Wx_eye, x·Wx_sig with
aud_ch·W_aud_sig in one sum, aud_h·W_aud1, h·W_sig1, h2·W_geo, geo·W_col_g)
as three TF32 products a term: each operand split into a = a_hi + a_lo,
a_hi rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, halves
away from zero, 10 mantissa bits: an integer add and mask on the f32 bits,
as the kernel does it), a_lo = a − a_hi of which a TF32 product reads the
top 19 bits (a truncation), then a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed
in f32. The narrow products (the eye's 16 → 1, σ's 64 → 1, rgb's 64 → 3)
are f32 dots. The TF32 products are f32 matmuls of TF32 values (exact: 11 ×
11 significant bits). Limit: K2's 1e-5 (``chip_smoke.K2_ATOL``); the same
head with single TF32 products (one rounded product a term, what TF32
matmuls give) must miss it and be at least 10× further off.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from mere_fusion_tpu.ops import pallas_sampler as jsamp
from mere_fusion_tpu_torch.ops import sampler as psamp
from tests.test_torch_nerf_ops import SAMPLER, k2_inputs, k2_torch

K2_ATOL = 1e-5


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite f32 values: the magnitude rounded to 10
    mantissa bits, halves away from zero (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value a tensor-core product reads from f32 bits: the 13 low
    bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products a term, summed in f32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product a term."""
    return tf32_rna(a) @ tf32_rna(b)


def head(x, dsamp, w: dict, mm):
    """head_tf32's arithmetic on per-sample features x [.., 48] and direction
    rows dsamp [.., 64]: the wide products through ``mm``, the narrow ones
    in f32. Returns (σ logit [..], rgb logits [.., 3])."""
    relu = torch.relu
    aud_ch = mm(relu(mm(x, w["wx_aud"])), w["w_aud1"])
    eye = torch.sigmoid(relu(mm(x, w["wx_eye"])) @ w["w_eye1"][:, :1])
    h = mm(torch.cat([x, aud_ch], dim=-1), torch.cat([w["wx_sig"], w["w_aud_sig"]]))
    h = relu(h + eye * w["w_sig_e"][0])
    h2 = relu(mm(h, w["w_sig1"]))
    geo = mm(h2, w["w_geo"])
    ch = relu(mm(geo, w["w_col_g"]) + dsamp + w["col_bias"][0])
    return (h2 @ w["w_sigcol"][:, :1])[..., 0], ch @ w["w_rgb"][:, 1:4]


def k2_emulated(planes, jobs, uv, dproj, dtv, weights, spec, mm):
    """K2 (sample, head, composite) with ``head`` through ``mm``."""
    t = uv.shape[0] // 3
    jobs = jobs.reshape(t, 3, 1 + 2 * spec.kg)
    uv = uv.reshape(t, 3, spec.kg, 2, spec.sg)
    x = psamp._tile_features(planes, jobs, uv, spec)
    sig, rgb = head(x, psamp._sample_rows(dproj, spec), weights, mm)
    return psamp._composite(sig, rgb, dtv[..., 0], spec)


def test_3xtf32_head_matches_pallas_interpret():
    scal, uv, planes, weights, proj, dtv = k2_inputs(0, "float32")
    ref = np.asarray(jsamp.sample_shade_comp_tiles(
        jnp.asarray(planes, jnp.bfloat16), jnp.asarray(scal), jnp.asarray(uv),
        jnp.asarray(proj), jnp.asarray(dtv),
        {k: jnp.asarray(v, jnp.float32) for k, v in weights.items()},
        jsamp.SamplerSpec(**SAMPLER), interpret=True))
    args = k2_torch(scal, uv, planes, weights, proj, dtv, "float32")
    spec = psamp.SamplerSpec(**SAMPLER)
    err = {name: float(np.abs(k2_emulated(*args, spec, mm).numpy() - ref).max())
           for name, mm in (("3xtf32", mm_3xtf32), ("tf32", mm_tf32))}
    print(f"K2 f32 head against the JAX K2: three TF32 products {err['3xtf32']:.3e}, "
          f"one {err['tf32']:.3e}")
    assert np.abs(ref[..., 0]).max() > 0.5, "the test tiles must be well occupied"
    assert err["3xtf32"] <= K2_ATOL < err["tf32"]
    assert err["tf32"] >= 10 * err["3xtf32"]


def test_tf32_rounding_is_cvt_rna():
    """The emulated cvt.rna: 10 mantissa bits, halves away from zero, for
    both signs; values already in TF32 unchanged; the truncation drops the
    same bits toward zero."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 4, -(1.0 + one_ulp / 2),
                      1.0 + 3 * one_ulp / 2, 3.0e-30, -7.25])
    want = torch.tensor([1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + 2 * one_ulp,
                         float(np.float32(3.0e-30)), -7.25])
    got = tf32_rna(x)
    assert torch.equal(got[:5], want[:5]) and got[6] == want[6]
    assert abs(float(got[5]) / 3.0e-30 - 1) < 2.0 ** -10
    assert torch.equal(tf32_rna(got), got)
    assert torch.equal(tf32_trunc(x[[1, 3, 4]]), torch.tensor([1.0, -1.0, 1.0 + one_ulp]))


def test_tf32_block_layout_matches_the_kernel():
    """The wrapper's shared-memory count for a K2 block with f32 weights
    follows csrc/sampler_core.cuh's layout (Wᵀ rows padded by 8 floats, the
    f32 vectors, each warp's x rows), and the tiles K2 serves and profiles
    (16×8 and 32×8 rays × 16 samples) fit a block."""
    import re

    with open(psamp.CORE_HEADER) as f:
        text = f.read()
    warps, mt = (int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
                 for name in ("TF_WARPS", "TF_MT"))
    xd, hid, aud, eye = 3 * psamp.CP, psamp.HID, psamp.AUD, psamp.EYE_HID
    weights = (2 * hid * (xd + 8) + eye * (xd + 8) + aud * (hid + 8) + hid * (aud + 8)
               + 3 * hid * (hid + 8))
    vectors = eye + hid + hid + 4 * hid + hid
    assert psamp.TF32_FIXED_BYTES == 4 * (weights + vectors + warps * 16 * mt * (xd + 8))
    for tile_w in (16, 32):
        spec = psamp.SamplerSpec(resolution=1024, channels=12, tile_w=tile_w, tile_h=8, k=16,
                                 kg=4, wu=64, wv=32)
        assert psamp.tf32_smem_bytes(spec) <= psamp.SMEM_LIMIT
