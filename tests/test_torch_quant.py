"""MuseTalk's int8 serving tier in the port (ops/quant.py, the int8 rungs of
the VAE decode and the UNet, MuseModels' load-time gate) against the JAX
package on the CPU.

- The quantizers give JAX's int8 values, but for values within an ulp of a
  .5 boundary (counted), and JAX's scales within 2 ulp.
- ``int8_conv``'s plain version gives JAX's ``int8_conv`` within half a
  quantisation step sx·sw[o] plus 127 steps for each int8 value that the two
  quantisations round apart (a flipped value moves an output by at most
  sx·sw·127); none flip on these inputs.
- Every int8 conv of the toy decode and UNet, fed the input that conv got
  inside JAX's own forward, gives JAX's output within half a step: the
  port's arithmetic is JAX's conv by conv.
- The whole int8 decode and UNet are chaotic in their roundings: a rounding
  that flips at one conv moves the next conv's input by a quantisation step,
  which flips more roundings downstream, so two arithmetics that differ by
  an ulp anywhere (GroupNorm, attention, a pow) land on two realisations of
  the int8 noise. ``test_int8_decode_cascades`` shows it on the port alone.
  The whole-network limits are therefore held against the int8 noise
  itself: the port's int8 output is within INT8_NOISE_FACTOR times the
  int8-vs-float error of JAX's int8 output.
- The gate, on JAX's own probe inputs and the same weights: the same rung
  kept, each rung's PSNR within GATE_PSNR_TOL_DB of JAX's (the composed
  step's int8 noise is a realisation of its own in each package), on toy
  weights where no rung lies within GATE_MARGIN_DB of the 40 dB floor.
"""
from __future__ import annotations

import asyncio
import dataclasses
import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mere_fusion_tpu.engines.muse import MuseModels as JaxMuseModels
from mere_fusion_tpu.models.musetalk import AutoencoderKL as JaxVAE
from mere_fusion_tpu.models.musetalk import UNet2DCondition as JaxUNet
from mere_fusion_tpu.ops import quant as jq
from mere_fusion_tpu_torch.audio.features import WhisperFeatureExtractor
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.convert import unet_from_flax, vae_from_flax
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines.muse import MuseModels, psnr_db, synthesize_muse_avatar
from mere_fusion_tpu_torch.models.musetalk import (
    AutoencoderKL,
    UNetConfig,
    VAEConfig,
)
from mere_fusion_tpu_torch.models.whisper import WhisperDims
from mere_fusion_tpu_torch.ops import quant
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server.app import create_app
from tests.test_musetalk import SMALL_WHISPER, TINY_UNET, TINY_VAE
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
PORT_VAE = VAEConfig(**dataclasses.asdict(TINY_VAE))
PORT_UNET = UNetConfig(**dataclasses.asdict(TINY_UNET))
FACE = 32                      # 16² latents
LATENT = FACE // 2
# a flipped int8 value moves an output by at most 127 quantisation steps
# sx·sw[o]; with none flipped, the scales' ulps move it by well under half a step
HALF_STEP = 0.5
FLIP_STEPS = 127
MAX_FLIPS = 2
# the whole int8 decode / UNet: the port's int8 output against JAX's, in units
# of JAX's own int8-vs-float error (max and RMS); two independent
# realisations of the same noise differ by about √2 of it in RMS
INT8_NOISE_FACTOR = 2.0
# the gate: rungs' PSNRs, port against JAX. The composed step's int8 noise
# is a different realisation in each package (see above): on these weights the
# rungs read 0.15–0.45 dB apart. The toy weights keep every rung at least
# GATE_MARGIN_DB from the 40 dB floor in both packages, so the same rung is kept.
GATE_PSNR_TOL_DB = 0.75
GATE_MARGIN_DB = 1.0
# the decoder's output conv scaled by this: each rung's error grows (up to
# clipping), so the walk fails five rungs and keeps the last, vae_keep_top2
WALK_DECODER_SCALE = 5.0


def t_(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def ulps(a, b) -> np.ndarray:
    """|a − b| in float32 ulps of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b)).astype(np.float64)


@pytest.fixture(scope="module")
def jax_vars():
    """The JAX init of the toy VAE and UNet (MuseModels' seeds 0 and 1)."""
    m = JaxMuseModels(TINY_VAE, TINY_UNET, face_size=FACE, vae_int8="off")
    return m.vae_vars, m.unet_vars


@pytest.fixture(scope="module")
def port_models(jax_vars):
    vae_vars, unet_vars = jax_vars
    return MuseModels(PORT_VAE, PORT_UNET, vae_state=vae_from_flax(vae_vars, PORT_VAE),
                      unet_state=unet_from_flax(unet_vars, PORT_UNET), face_size=FACE,
                      device=CPU, vae_int8="off")


# ---- the quantizers and int8_conv ------------------------------------------------

def jax_quantisation(x, k):
    """JAX int8_conv's own intermediate values (mere_fusion_tpu/ops/quant.py:
    the lines before the conv) for NHWC x and HWIO k: (x's int8 values, the
    weights' int8 values, the dequantising scale sx·sw)."""
    return tuple(np.asarray(a) for a in _jax_quantisation_traced(x, k))


def jax_quantisation_jit(x, k):
    """jax_quantisation as a jitted forward computes it."""
    return tuple(np.asarray(a) for a in jax.jit(
        lambda x, k: tuple(jnp.asarray(v) for v in _jax_quantisation_traced(x, k)))(x, k))


def _jax_quantisation_traced(x, k):
    kf = k.astype(jnp.float32)
    ax = jnp.max(jnp.abs(x), axis=(0, 1, 2)).astype(jnp.float32)
    ak = jnp.max(jnp.abs(kf), axis=(0, 1, 3))
    ok = (ax > 0) & (ak > 0)
    s = jnp.where(ok, jnp.maximum(ax, 1e-8) ** 0.7 / jnp.maximum(ak, 1e-8) ** 0.3, 1.0)
    sx = jnp.maximum(jnp.max(jnp.where(ok, ax / s, ax)) / 127.0, 1e-12)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) * (1.0 / (s * sx))), -127, 127)
    kq, sw = jq.quantize_per_out_channel(kf * s[None, None, :, None])
    return xq, kq.astype(jnp.float32), sx * sw


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizers_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 7, 7, 5)) * 3.0).astype(np.float32)
    k = rng.standard_normal((3, 3, 5, 11)).astype(np.float32)
    xq, s = jq.quantize_per_tensor(jnp.asarray(x))
    pxq, ps = quant.quantize_per_tensor(t_(x))
    assert pxq.dtype == torch.int8 and ulps(ps.numpy(), s).max() <= 2
    kq, sw = jq.quantize_per_out_channel(jnp.asarray(k))
    pkq, psw = quant.quantize_per_out_channel(t_(k).permute(3, 2, 0, 1))
    assert pkq.dtype == torch.int8 and ulps(psw.numpy(), sw).max() <= 2
    for got, ref, scaled in ((pxq.numpy(), np.asarray(xq), x / float(s)),
                             (pkq.permute(2, 3, 1, 0).numpy(), np.asarray(kq),
                              k / np.asarray(sw))):
        apart = got != ref
        # a value the two round apart lies within an ulp of a .5 boundary
        near_half = np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) <= 2 * np.spacing(
            np.abs(scaled).astype(np.float32))
        assert not (apart & ~near_half).any()
        assert apart.sum() <= 2
    # the int8_conv operands: s·K's int8 values and sx·sw against JAX's own
    xj, kj, scale_j = jax_quantisation(jnp.asarray(x), jnp.asarray(k))
    mult, kq_p, scale_p = quant.int8_operands(t_(x).permute(0, 3, 1, 2),
                                              t_(k).permute(3, 2, 0, 1))
    assert ulps(scale_p.numpy(), scale_j).max() <= 2
    assert (kq_p.permute(2, 3, 1, 0).numpy() != kj).sum() <= 2
    xp = quant.quantize_activation_plain(t_(x).permute(0, 3, 1, 2), mult)
    assert (xp.permute(0, 2, 3, 1).numpy() != xj).sum() <= 2


# ---- int8_operands step by step: the plain functions K5's operand kernels hold to ----

def toy_operands(dtype: str, seed: int = 4):
    """(JAX x NHWC, JAX kernel HWIO, port x NCHW, port weight OIHW) in dtype:
    an outlier channel, a dead activation channel and a dead weight column
    (both give s = 1), 12 input channels (cp 16)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 6, 5, 12)) * 2.0).astype(np.float32)
    x[..., 1] *= 30.0
    x[..., 4] = 0.0
    k = (rng.standard_normal((3, 3, 12, 20)) / 6.0).astype(np.float32)
    k[:, :, 7, :] = 0.0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    return (jnp.asarray(x, jdt), jnp.asarray(k, jdt),
            torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2),
            torch.from_numpy(k).to(tdt).permute(3, 2, 0, 1))


def jax_factors(jx, jk):
    """JAX int8_conv's amax and SmoothQuant factors (mere_fusion_tpu/ops/
    quant.py:79-92) as numpy: ax, ak, s, sx, mult."""
    kf = jk.astype(jnp.float32)
    ax = jnp.max(jnp.abs(jx), axis=(0, 1, 2)).astype(jnp.float32)
    ak = jnp.max(jnp.abs(kf), axis=(0, 1, 3))
    ok = (ax > 0) & (ak > 0)
    s = jnp.where(ok, jnp.maximum(ax, 1e-8) ** 0.7 / jnp.maximum(ak, 1e-8) ** 0.3, 1.0)
    sx = jnp.maximum(jnp.max(jnp.where(ok, ax / s, ax)) / 127.0, 1e-12)
    return tuple(np.asarray(a) for a in (ax, ak, s, sx, 1.0 / (s * sx)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_amax_matches_jax(dtype):
    jx, jk, px, pk = toy_operands(dtype)
    ax, ak = quant.channel_amax(px, pk)
    jax_ax, jax_ak, *_ = jax_factors(jx, jk)
    assert ax.dtype == ak.dtype == torch.float32
    assert np.array_equal(ax.numpy(), jax_ax) and np.array_equal(ak.numpy(), jax_ak)
    assert ax[4] == 0 and ak[7] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smooth_factors_match_jax(dtype):
    jx, jk, _, _ = toy_operands(dtype)
    jax_ax, jax_ak, jax_s, jax_sx, jax_mult = jax_factors(jx, jk)
    s, sx, mult = quant.smooth_factors(t_(jax_ax.copy()), t_(jax_ak.copy()))
    assert s.shape == mult.shape == (12,) and sx.dim() == 0
    assert s[4] == 1 and s[7] == 1            # a dead channel either side: no equalisation
    assert ulps(s.numpy(), jax_s).max() <= 2
    assert ulps(sx.numpy(), jax_sx).max() <= 2
    assert ulps(mult.numpy(), jax_mult).max() <= 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_weights_matches_jax(dtype):
    """The packed weights and sx·sw against JAX's quantize_per_out_channel
    on s·K (mere_fusion_tpu/ops/quant.py:43) for the same s and sx, and the
    conv kernel's tap-major layout against JAX's HWIO values transposed."""
    jx, jk, _, pk = toy_operands(dtype)
    *_, jax_s, jax_sx, _ = jax_factors(jx, jk)
    kq, scale = quant.pack_weights(pk, t_(jax_s.copy()), torch.tensor(float(jax_sx)))
    jkq, jsw = jq.quantize_per_out_channel(
        jk.astype(jnp.float32) * jnp.asarray(jax_s)[None, None, :, None])
    jkq = np.asarray(jkq)
    assert kq.dtype == torch.int8 and scale.dtype == torch.float32
    assert (kq.permute(2, 3, 1, 0).numpy() != jkq).sum() <= 2
    assert ulps(scale.numpy(), jax_sx * np.asarray(jsw)).max() <= 2
    cp = quant.padded_channels(12)
    packed = quant.tap_major(kq, cp)
    assert cp == 16 and packed.shape == (20, 9, 16) and packed.dtype == torch.int8
    want = np.zeros((20, 9, cp), np.int8)
    want[:, :, :12] = np.transpose(jkq, (3, 0, 1, 2)).reshape(20, 9, 12)
    assert (packed.numpy() != want).sum() <= 2
    assert not packed[:, :, 12:].any()


def test_int8_operands_compose_the_steps():
    _, _, px, pk = toy_operands("bfloat16")
    s, sx, mult = quant.smooth_factors(*quant.channel_amax(px, pk))
    kq, scale = quant.pack_weights(pk, s, sx)
    for got, want in zip(quant.int8_operands(px, pk), (mult, kq, scale)):
        assert torch.equal(got, want)


# (n, h, w, cin, cout, k, stride)
CONV_CASES = {
    "3x3": (2, 9, 9, 24, 40, 3, 1),
    "1x1": (2, 8, 8, 48, 24, 1, 1),
    "3x3_s2": (2, 10, 10, 32, 32, 3, 2),
    "cin4": (2, 8, 8, 4, 64, 3, 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_plain_matches_jax(case, dtype):
    n, h, w, cin, cout, k, stride = CONV_CASES[case]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    x[..., 0] *= 25.0                       # an outlier channel: s moves it into the weights
    kern = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    pad = k // 2
    jx, jk, jb = (jnp.asarray(a, jdt) for a in (x, kern, bias))
    ref = np.asarray(jq.int8_conv(jx, jk, jb, (stride, stride), ((pad, pad), (pad, pad)),
                                  out_dtype=jdt).astype(jnp.float32))
    px = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    pk = torch.from_numpy(kern).to(tdt).permute(3, 2, 0, 1)
    before = quant.launches
    got = quant.int8_conv(px, pk, torch.from_numpy(bias).to(tdt), stride, pad)
    assert quant.launches == before, "a CPU tensor must take the plain version"
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    xj, kj, _ = jax_quantisation(jx, jk)
    mult, kq_p, scale = quant.int8_operands(px, pk)
    flips = int((quant.quantize_activation_plain(px, mult).permute(0, 2, 3, 1).numpy() != xj)
                .sum() + (kq_p.permute(2, 3, 1, 0).numpy() != kj).sum())
    steps = np.abs(got - ref) / scale.numpy()
    limit = HALF_STEP + FLIP_STEPS * flips
    if dtype == "bfloat16":     # the output's own rounding: half a bf16 ulp of each side
        limit += float((np.abs(ref) * 2.0 ** -8 / scale.numpy()).max())
    print(f"int8_conv {case} {dtype}: {flips} int8 values apart, "
          f"max {steps.max():.3g} steps (limit {limit:.3g})")
    assert flips <= 2 and steps.max() <= limit
    # against the float conv: within the int8 error expected of these scales
    full = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + bias
    assert np.abs(got - full).max() < 0.05 * np.abs(full).max()


def test_qconv_float_route_is_nn_conv2d():
    torch.manual_seed(0)
    ref = torch.nn.Conv2d(6, 10, 3, stride=2, padding=1)
    ours = quant.QConv(6, 10, 3, stride=2, padding=1)
    assert list(ours.state_dict()) == list(ref.state_dict())
    assert all(a.shape == b.shape for a, b in zip(ours.state_dict().values(),
                                                  ref.state_dict().values()))
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(2, 6, 9, 9)
    assert torch.equal(ours(x), ref(x))
    ours.quant = True
    assert torch.equal(ours(x), quant.int8_conv_plain(x, ref.weight, ref.bias, 2, 1))


def test_cuda_route_refuses_cpu_tensors():
    x, w = torch.randn(1, 8, 6, 6), torch.randn(8, 8, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        quant.conv_q_cuda(x, *quant.int8_operands(x, w), None, 1, 1)


# ---- the toy decode and UNet, conv by conv and whole ---------------------------

def _port_name(path: tuple) -> str:
    """A JAX QConv's module path → the port module's name (diffusers')."""
    name = "/".join(path)
    for pat, rep in ((r"^decoder/conv_in$", "decoder.conv_in"),
                     (r"mid_res_(\d+)/", r"mid_block.resnets.\1."),
                     (r"up_(\d+)_res_(\d+)/", r"up_blocks.\1.resnets.\2."),
                     (r"down_(\d+)_res_(\d+)/", r"down_blocks.\1.resnets.\2."),
                     (r"up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0.conv"),
                     (r"down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv")):
        name = re.sub(pat, rep, name)
    return name.replace("/", ".")


def jax_int8_forward(module, variables, *args, method=None):
    """JAX's forward with every int8 QConv's input and output recorded:
    (output, {port module name: (x NHWC, y NHWC)}), one jitted call."""
    names = []

    def run(variables, *args):
        rec = []

        def intercept(next_fun, a, kw, ctx):
            out = next_fun(*a, **kw)
            if (isinstance(ctx.module, jq.QConv) and ctx.method_name == "__call__"
                    and ctx.module.quant):
                names.append(_port_name(ctx.module.scope.path))
                rec.append((a[0], out))
            return out

        with nn.intercept_methods(intercept):
            return module.apply(variables, *args, method=method), rec

    out, rec = jax.jit(run)(variables, *args)
    return np.asarray(out), {n: (np.asarray(x), np.asarray(y)) for n, (x, y) in zip(names, rec)}


def check_convs(model: torch.nn.Module, recorded: dict) -> None:
    """The port's int8 convs are JAX's, and each gives JAX's output, on the
    input it got inside JAX's forward, within half a quantisation step plus
    127 steps for each int8 value the two quantisations round apart (a value
    within an ulp of a .5 boundary, where the two packages' pow may differ by
    an ulp in s); at most MAX_FLIPS such values in a conv. The values JAX
    rounds are re-derived under jit, as its forward runs them: XLA's fused
    pow differs from its eager pow by an ulp in s at some channels."""
    mods = dict(model.named_modules())
    ours = {n for n, m in mods.items() if isinstance(m, quant.QConv) and m.quant}
    assert ours == set(recorded)
    worst, flips_total = 0.0, 0
    for name, (x, y) in recorded.items():
        px, weight = t_(x).permute(0, 3, 1, 2), mods[name].weight
        with torch.no_grad():
            got = mods[name](px).permute(0, 2, 3, 1).numpy()
        mult, kq, scale = quant.int8_operands(px, weight)
        xj, kj, _ = jax_quantisation_jit(jnp.asarray(x), jnp.asarray(
            weight.detach().permute(2, 3, 1, 0).numpy()))
        flips = int((quant.quantize_activation_plain(px, mult).permute(0, 2, 3, 1).numpy()
                     != xj).sum() + (kq.permute(2, 3, 1, 0).numpy() != kj).sum())
        steps = float((np.abs(got - y) / scale.numpy()).max())
        assert flips <= MAX_FLIPS and steps <= HALF_STEP + FLIP_STEPS * flips, (name, flips, steps)
        worst, flips_total = max(worst, steps), flips_total + flips
    print(f"{len(recorded)} int8 convs, {flips_total} int8 values apart, worst "
          f"{worst:.3g} quantisation steps from JAX's")


def noise_check(what: str, got, ref, ref_float) -> None:
    """The port's int8 output against JAX's within INT8_NOISE_FACTOR times
    JAX's int8-vs-float error, in max and in RMS."""
    err, noise = got - ref, ref - ref_float
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    print(f"{what}: port−JAX max {np.abs(err).max():.3g} rms {rms(err):.3g}; "
          f"JAX int8−float max {np.abs(noise).max():.3g} rms {rms(noise):.3g}")
    assert np.abs(err).max() <= INT8_NOISE_FACTOR * np.abs(noise).max()
    assert rms(err) <= INT8_NOISE_FACTOR * rms(noise)


@pytest.mark.parametrize("fp_up_blocks,n_int8", [(0, 19), (1, 12), (2, 5)])
def test_int8_decode_matches_jax(jax_vars, port_models, fp_up_blocks, n_int8):
    """AutoencoderKL(int8_decode=True, int8_fp_up_blocks=k) at k = 0 (full),
    1 (keep_top1) and 2 (keep_top2: the toy has two up blocks), on the same
    weights and latents."""
    vae_vars, _ = jax_vars
    z = np.random.default_rng(4).standard_normal((2, LATENT, LATENT, 4)).astype(np.float32)
    jvae = JaxVAE(TINY_VAE, int8_decode=True, int8_fp_up_blocks=fp_up_blocks)
    ref, recorded = jax_int8_forward(jvae, vae_vars, jnp.asarray(z), method=JaxVAE.decode)
    vae = port_models.vae
    try:
        vae.set_int8_decode(True, fp_up_blocks)
        assert len(recorded) == n_int8
        check_convs(vae, recorded)
        with torch.no_grad():
            got = vae.decode(t_(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
            vae.set_int8_decode(False)
            flt = vae.decode(t_(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    finally:
        vae.set_int8_decode(False)
    noise_check(f"decode keeping {fp_up_blocks} up blocks float", got, ref, flt)


def test_int8_unet_matches_jax(jax_vars, port_models):
    _, unet_vars = jax_vars
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, LATENT, LATENT, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 50, TINY_UNET.cross_attention_dim)).astype(np.float32)
    t = np.zeros((2,), np.float32)
    ref, recorded = jax_int8_forward(JaxUNet(TINY_UNET, int8=True), unet_vars,
                                     jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    unet = port_models.unet
    args = (t_(lat).permute(0, 3, 1, 2), t_(t), t_(ctx))
    try:
        unet.set_int8(True)
        # every resnet conv and resample conv: 2 and 3 (a shortcut) in the
        # down blocks with the downsample, 4 in the mid block, 4 resnets × 3
        # (each with a shortcut over its skip) in the up blocks with the upsample
        assert len(recorded) == 23
        check_convs(unet, recorded)
        with torch.no_grad():
            got = unet(*args).permute(0, 2, 3, 1).numpy()
            unet.set_int8(False)
            flt = unet(*args).permute(0, 2, 3, 1).numpy()
    finally:
        unet.set_int8(False)
    noise_check("UNet", got, ref, flt)


def test_int8_decode_cascades():
    """The int8 decode's roundings are chaotic: a perturbation of 1e-6
    relative of its input moves the port's own int8 decode by as much as
    int8 moves it from float (while the float decode moves by ~1e-6), which
    is why the whole-network limits above are held against the int8 noise
    and not at an ulp."""
    torch.manual_seed(0)
    vae = AutoencoderKL(PORT_VAE).eval()
    rng = np.random.default_rng(6)
    z = t_(rng.standard_normal((2, 4, LATENT, LATENT)))
    nudged = z * (1 + 1e-6 * t_(rng.standard_normal(z.shape)))
    with torch.no_grad():
        flt, flt_n = vae.decode(z), vae.decode(nudged)
        vae.set_int8_decode(True)
        q, q_n = vae.decode(z), vae.decode(nudged)
    assert (flt - flt_n).abs().max() < 1e-4
    assert (q - q_n).abs().max() > 0.25 * (q - flt).abs().max()


# ---- the gate ------------------------------------------------------------------

def jax_probe():
    """JAX MuseModels' own gate probe: normal of keys 2 and 3."""
    z = jax.random.normal(jax.random.key(2), (2, LATENT, LATENT, TINY_UNET.in_channels))
    fz = jax.random.normal(jax.random.key(3), (2, 50, TINY_UNET.cross_attention_dim))
    return t_(z), t_(fz)


def scaled_decoder(vae_vars, k: float):
    """vae_vars with the decoder's conv_out kernel and bias times k."""
    out = jax.tree.map(lambda a: a, vae_vars)
    conv = dict(out["params"]["decoder"]["conv_out"])
    conv["kernel"], conv["bias"] = conv["kernel"] * k, conv["bias"] * k
    out["params"]["decoder"] = {**out["params"]["decoder"], "conv_out": conv}
    return out


def test_gate_matches_jax(jax_vars):
    """JAX MuseModels(vae_int8="auto") and the port's on the same weights and
    JAX's probe walk all six rungs and keep vae_keep_top2."""
    vae_vars, unet_vars = jax_vars
    decoder_scale, tier = WALK_DECODER_SCALE, "vae_keep_top2"
    vae_vars = scaled_decoder(vae_vars, decoder_scale)
    jm = JaxMuseModels(TINY_VAE, TINY_UNET, face_size=FACE, vae_int8="auto",
                       vae_vars=vae_vars, unet_vars=unet_vars)
    pm = MuseModels(PORT_VAE, PORT_UNET, vae_state=vae_from_flax(vae_vars, PORT_VAE),
                    unet_state=unet_from_flax(unet_vars, PORT_UNET), face_size=FACE,
                    device=CPU, vae_int8="off")
    assert pm.int8_gate(jax_probe()) == pm.int8_tier     # what "auto" runs, on JAX's probe
    print(f"gate, decoder ×{decoder_scale}: JAX {jm.int8_tier} {jm.int8_gate_probes}; "
          f"port {pm.int8_tier} {pm.int8_gate_probes} in {pm.int8_gate_seconds:.2f} s")
    assert jm.int8_tier == pm.int8_tier == tier
    assert list(pm.int8_gate_probes) == list(jm.int8_gate_probes)
    for name, ref in jm.int8_gate_probes.items():
        got = pm.int8_gate_probes[name]
        assert abs(got - ref) <= GATE_PSNR_TOL_DB
        assert min(abs(got - 40.0), abs(ref - 40.0)) >= GATE_MARGIN_DB
    assert pm.int8_gate_psnr == pm.int8_gate_probes[tier] and pm.int8_enabled
    # the kept rung serves: the generate's faces are the composed step's
    z, fz = jax_probe()
    img = pm.image(z, fz)
    faces = pm.generate(z, fz)
    assert torch.equal(faces, torch.round(img * 255).to(torch.uint8).permute(0, 2, 3, 1)
                       .flip(-1))
    pm.set_int8_tier("off")
    assert psnr_db(img, pm.image(z, fz)) == pm.int8_gate_probes[tier]


def test_on_and_off(jax_vars, port_models):
    """"on" (and True) is JAX's "full" tier: the int8 VAE decode, a float
    UNet; "off" (and False) the float step; neither runs the gate."""
    vae_vars, unet_vars = jax_vars
    states = (vae_from_flax(vae_vars, PORT_VAE), unet_from_flax(unet_vars, PORT_UNET))
    for mode, tier in (("on", "full"), (True, "full"), ("off", "off"), (False, "off")):
        jm = JaxMuseModels(TINY_VAE, TINY_UNET, face_size=FACE, vae_int8=mode,
                           vae_vars=vae_vars, unet_vars=unet_vars)
        pm = MuseModels(PORT_VAE, PORT_UNET, *states, face_size=FACE, device=CPU,
                        vae_int8=mode)
        assert jm.int8_tier == pm.int8_tier == tier
        assert jm.int8_enabled == pm.int8_enabled == (tier == "full")
        assert pm.int8_gate_probes == {} and pm.int8_gate_psnr is None
        quantised = {n for n, m in pm.vae.named_modules()
                     if isinstance(m, quant.QConv) and m.quant}
        assert len(quantised) == (19 if tier == "full" else 0)
        assert not any(m.quant for m in pm.unet.modules() if isinstance(m, quant.QConv))
    with pytest.raises(ValueError, match="auto|on|off"):
        MuseModels(PORT_VAE, PORT_UNET, *states, face_size=FACE, device=CPU, vae_int8="full")
    # "on" serves the gate's vae_full rung
    z, fz = jax_probe()
    pm = MuseModels(PORT_VAE, PORT_UNET, *states, face_size=FACE, device=CPU, vae_int8="on")
    on = pm.image(z, fz)
    pm.set_int8_tier("vae_full")
    assert torch.equal(on, pm.image(z, fz))


@pytest.mark.parametrize("mode,tier", [("auto", "unet_int8+vae_full"), ("on", "full"),
                                       ("off", "off")])
def test_start_session_serves_each_vae_int8_mode(jax_vars, mode, tier):
    """/start_session with avatar.vae_int8 auto, on and off (the CLI's
    --vae_int8) builds MuseModels from the configuration, starts, and serves
    generated frames on the rung it chose; "on" no longer fails the start."""
    vae_vars, unet_vars = jax_vars
    states = (vae_from_flax(vae_vars, PORT_VAE), unet_from_flax(unet_vars, PORT_UNET))
    cfg = Config().override(**{
        "avatar.kind": "musetalk", "avatar.batch_size": 2, "avatar.dtype": "float32",
        "avatar.vae_int8": mode, "tts.backend": "procedural", "stride.left": 4,
        "stride.right": 4, "transport.mode": "loopback", "server.max_sessions": 1})
    served = []

    def factory(c, **kw):
        models = MuseModels(PORT_VAE, PORT_UNET, *states, face_size=FACE, device=CPU,
                            vae_int8=c.avatar.vae_int8)
        served.append(models.int8_tier)
        extractor = WhisperFeatureExtractor(dims=WhisperDims(**dataclasses.asdict(SMALL_WHISPER)),
                                            device=CPU)
        return make_engine(c, models=models, avatar=synthesize_muse_avatar(models, 4),
                           feature_extractor=extractor, **kw)

    def generated() -> float:
        return metrics.snapshot()["counters"].get("muse.generated_frames", 0.0)

    async def main():
        client = TestClient(TestServer(create_app(cfg, factory, devices=[CPU])))
        await client.start_server()
        try:
            body = await (await client.post("/start_session", json={})).json()
            assert body["code"] == 0, body
            start = generated()
            r = await client.post("/talk", json={"session_id": body["session_id"],
                                                 "type": "echo", "text": "int eight"})
            assert (await r.json())["code"] == 0
            for _ in range(600):
                if generated() >= start + 4:
                    break
                await asyncio.sleep(0.1)
            assert generated() >= start + 4
            r = await client.post("/stop_session", json={"session_id": body["session_id"]})
            assert (await r.json())["code"] == 0
        finally:
            await client.close()

    asyncio.run(main())
    assert served == [tier]
