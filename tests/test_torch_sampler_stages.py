"""S1 and S2 (ops/sampler_stages.py, K2's stages alone) and the profiling
entry points mere_fusion_tpu_torch/scripts/prof_r5k.py and prof_r5m.py
against their JAX twins scripts/prof_r5k.py and scripts/prof_r5m.py, on the
CPU.

The port's ``prof_r5m.m1_only`` (both modes) and ``prof_r5m.sections``
(win, shade, full; bf16 and float32 weights) run their plain versions here;
the reference's run their Pallas kernels with ``pl.pallas_call`` patched to
interpret mode (as tests/test_torch_attention.py does), at the toy spec of
tests/test_torch_sampler_family.py (R = 128, 4×4 tiles, k = 8, kg = 2,
wu = 32, wv = 16: 256 window lanes) and 4 tiles, with ``prof_r5m.N_RAYS``
patched to match. Inputs come from numpy with the reference's
distributions (``make_inputs``: ou, ov multiples of 8, u absolute, v
window-local, planes filling all 16 lanes). Importing the reference
scripts points JAX's compilation cache elsewhere for the whole process, so
a fixture imports them and puts both settings back.

Tolerances, with their reasons:
- S1: 1e-6 of the largest value. Each output sums products of bf16 values
  (exact in float32) in the reference's order: 0 is expected;
- win: 1e-5 of the largest value (the features' f32 sums in another order:
  the TPU folds lanes with matmuls);
- shade: 1e-4 of each value (K2b's limit: the head's f32 sums in another
  order);
- full: 1e-5 (K2's limit).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mere_fusion_tpu.ops.pallas_sampler import SamplerSpec as JSpec
from mere_fusion_tpu_torch.ops import sampler as psamp
from mere_fusion_tpu_torch.ops import sampler_stages
from mere_fusion_tpu_torch.scripts import prof_r5k, prof_r5m

SAMPLER = dict(resolution=128, channels=4, tile_w=4, tile_h=4, k=8, kg=2, wu=32, wv=16)
JSPEC, PSPEC = JSpec(**SAMPLER), psamp.SamplerSpec(**SAMPLER)
TILES = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """(scripts.prof_r5k, scripts.prof_r5m), imported with JAX's compilation
    cache settings put back as they were."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache = jax.config.jax_compilation_cache_dir
    try:
        import scripts.prof_r5k as jk
        import scripts.prof_r5m as jm
    finally:
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
        jax.config.update("jax_compilation_cache_dir", cache)
    return jk, jm


@pytest.fixture()
def jm(ref, monkeypatch):
    """scripts.prof_r5m with its Pallas kernels in interpret mode and
    N_RAYS at TILES tiles of the toy spec."""
    _, jm = ref
    monkeypatch.setattr(jm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jm, "N_RAYS", TILES * PSPEC.rays_per_tile)
    return jm


def bf16(a) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def inputs():
    """make_inputs' operands for TILES tiles of the toy spec, drawn with
    numpy from the reference's distributions (bf16 values held as f32)."""
    rng = np.random.default_rng(0)
    r, kg, sg, t = SAMPLER["resolution"], PSPEC.kg, PSPEC.sg, TILES
    j = 3 * t
    ou = rng.integers(0, r - PSPEC.wu, (j, kg)) // 8 * 8
    ov = rng.integers(0, r - PSPEC.wv, (j, kg)) // 8 * 8
    scal = np.zeros((j, 1 + 2 * kg), np.int32)
    scal[:, 1::2], scal[:, 2::2] = ou, ov
    u = ou[:, :, None] + rng.uniform(0, PSPEC.wu - 1.01, (j, kg, sg))
    v = rng.uniform(0, PSPEC.wv - 1.01, (j, kg, sg))          # window-local, as the reference
    uv = np.stack([u, v], axis=2).astype(np.float32)
    planes = bf16(rng.standard_normal((3, PSPEC.mip_rows[-1], r * 16)))
    dproj = bf16(rng.standard_normal((t, PSPEC.rays_per_tile, 64)))
    dtv = np.zeros((t, PSPEC.rays_per_tile, 8), np.float32)
    dtv[..., 0] = 0.01
    weights = {k: bf16(0.1 * rng.standard_normal(psamp.WEIGHT_SHAPES[k]))
               for k in psamp.SHADE_WEIGHTS}
    return scal.reshape(-1), uv, dproj, dtv, weights, planes


@pytest.mark.parametrize("blockdiag", [False, True])
def test_m1_only_matches_jax(jm, inputs, blockdiag):
    scal, uv, _, _, _, planes = inputs
    want = np.asarray(jm.m1_only(JSPEC, blockdiag)(
        jnp.asarray(scal), jnp.asarray(uv), jnp.asarray(planes, jnp.bfloat16)))
    got = prof_r5m.m1_only(PSPEC, blockdiag)(
        torch.from_numpy(scal), torch.from_numpy(uv), torch.from_numpy(planes).to(torch.bfloat16))
    rows = PSPEC.kg * PSPEC.sg if blockdiag else PSPEC.sg
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (TILES, rows, 128)
    scale = float(np.abs(want).max())
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("wdtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["win", "shade", "full"])
def test_sections_match_jax(jm, inputs, mode, wdtype):
    scal, uv, dproj, dtv, weights, planes = inputs
    jdt, pdt = getattr(jnp, wdtype), getattr(torch, wdtype)
    names = psamp.SHADE_WEIGHTS
    want = np.asarray(jm.sections(JSPEC, mode)(
        jnp.asarray(scal), jnp.asarray(uv), jnp.asarray(dproj, jdt), jnp.asarray(dtv),
        *[jnp.asarray(weights[k], jdt) for k in names], jnp.asarray(planes, jnp.bfloat16)))
    got = prof_r5m.sections(PSPEC, mode)(
        torch.from_numpy(scal), torch.from_numpy(uv), torch.from_numpy(dproj).to(pdt),
        torch.from_numpy(dtv), *[torch.from_numpy(weights[k]).to(pdt) for k in names],
        torch.from_numpy(planes).to(torch.bfloat16)).numpy()
    assert got.shape == want.shape == (TILES, PSPEC.rays_per_tile, 16)
    if mode == "win":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    elif mode == "shade":
        # every lane of both products: the padding columns of the weights are random
        assert np.abs(want[..., 4:]).min() > 0
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(want[..., 0].max()) > 0.01
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_make_inputs_has_the_references_weights_and_distributions(ref, monkeypatch):
    jk, _ = ref
    for mod in (jk, prof_r5k):          # 128² planes: a toy-sized draw for both
        monkeypatch.setattr(mod, "R", SAMPLER["resolution"])
    *_, jweights, jplanes = jk.make_inputs(JSPEC, TILES)
    gen = torch.Generator(device=CPU).manual_seed(0)
    scal, uv, dproj, dtv, weights, planes = prof_r5k.make_inputs(PSPEC, TILES, gen, CPU)
    for name in psamp.SHADE_WEIGHTS:    # bit for bit
        assert weights[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(weights[name].view(torch.int16).numpy(),
                                      np.asarray(jweights[name]).view(np.int16), err_msg=name)
    r, kg, sg, t = SAMPLER["resolution"], PSPEC.kg, PSPEC.sg, TILES
    assert planes.dtype == torch.bfloat16 and planes.shape == tuple(jplanes.shape)
    assert bool((planes.reshape(-1, 16)[:, 12:] != 0).any()), "the padding lanes are filled"
    jobs = scal.reshape(3 * t, 1 + 2 * kg)
    assert scal.dtype == torch.int32 and bool((jobs[:, 0] == 0).all())
    ou, ov = jobs[:, 1::2], jobs[:, 2::2]
    assert bool((ou % 8 == 0).all() & (ov % 8 == 0).all())
    assert bool((ou + PSPEC.wu <= r).all() & (ov + PSPEC.wv <= r).all())
    assert uv.dtype == torch.float32 and uv.shape == (3 * t, kg, 2, sg)
    u, v = uv[:, :, 0], uv[:, :, 1]
    assert bool(((u >= ou[..., None]) & (u < ou[..., None] + PSPEC.wu - 1.01)).all())
    assert bool(((v >= 0) & (v < PSPEC.wv - 1.01)).all()), "v is window-local"
    assert dproj.dtype == torch.bfloat16 and dproj.shape == (t, PSPEC.rays_per_tile, 64)
    assert bool((dtv[..., 0] == 0.01).all() & (dtv[..., 1:] == 0).all())


def test_wrappers_take_the_plain_version_on_the_cpu_and_the_kernels_raise(inputs):
    scal, uv, dproj, dtv, weights, planes = inputs
    scal, uv, dtv = map(torch.from_numpy, (scal, uv, dtv))
    planes, dproj = (torch.from_numpy(a).to(torch.bfloat16) for a in (planes, dproj))
    weights = {k: torch.from_numpy(w).to(torch.bfloat16) for k, w in weights.items()}
    before = (sampler_stages.m1_launches, sampler_stages.section_launches)
    out = sampler_stages.m1_only(planes, scal, uv, PSPEC)
    torch.testing.assert_close(out, sampler_stages.m1_only_plain(planes, scal, uv, PSPEC),
                               rtol=0, atol=0)
    full = sampler_stages.sections(planes, scal, uv, dproj, dtv, weights, PSPEC, "full")
    torch.testing.assert_close(full, psamp.sample_shade_comp_tiles_plain(
        planes, scal, uv, dproj, dtv, weights, PSPEC), rtol=0, atol=0)
    assert (sampler_stages.m1_launches, sampler_stages.section_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.m1_only_cuda(planes, scal, uv, PSPEC)
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.sections_cuda(planes, scal, uv, dproj, dtv, weights, PSPEC, "shade")
    with pytest.raises(ValueError, match="CUDA"):
        sampler_stages.sections_cuda(planes, scal, uv, dproj, dtv, weights, PSPEC, "full")
    with pytest.raises(ValueError, match="mode"):
        sampler_stages.sections(planes, scal, uv, dproj, dtv, weights, PSPEC, "head")


def test_profiling_entry_points_need_cuda():
    for main in (prof_r5k.main, prof_r5m.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            prof_r5m.main()


def test_prof_k2_probes_find_their_text():
    """prof_k2's probes are text edits of csrc/sampler.cu and
    csrc/sampler_core.cuh, where K2's kernels (and so S2's stages) live: each
    edit's text must be in its file once, or the script refuses to build the
    probe on the card."""
    from mere_fusion_tpu_torch.scripts import prof_k2

    texts = {}
    for name, path in (("sampler.cu", psamp._SRC), ("sampler_core.cuh", psamp.CORE_HEADER)):
        with open(path) as f:
            texts[name] = f.read()
    for probe, edits in prof_k2.PROBES.items():
        for file, old, _new in edits:
            assert texts[file].count(old) == 1, (probe, file, old[:60])


def test_m1_only_plain_clamps_windows_that_leave_the_planes(inputs):
    """S1's plain version takes the kernel's clamps (csrc/sampler_stages.cu:
    the plane into [0, 2], the window row into [0, rows − 2], the first
    lane's texel into [0, rv − 8]): on jobs whose windows cross the planes'
    last row and column, or start above and left of them, it equals a
    per-row float32 loop with those clamps, in both modes."""
    scal, uv, _, _, _, planes = inputs
    kg, sg, wu = PSPEC.kg, PSPEC.sg, PSPEC.wu
    rows, rv = planes.shape[1], planes.shape[2] // 16
    table, uv = scal.reshape(3 * TILES, 1 + 2 * kg).copy(), uv.copy()
    rng = np.random.default_rng(3)
    for first, (p, ou, ov) in ((0, (2, rows - wu // 2, rv - 3)), (1, (5, -(wu // 2), -5))):
        table[first::3, 0], table[first::3, 1::2], table[first::3, 2::2] = p, ou, ov
        uv[first::3, :, 0] = ou + rng.uniform(0, wu - 1.01, uv[first::3, :, 0].shape)
    table = table.reshape(TILES, 3, 1 + 2 * kg)
    uvt = uv.reshape(TILES, 3, kg, 2, sg)
    f32 = np.float32
    for blockdiag in (False, True):
        got = sampler_stages.m1_only_plain(torch.from_numpy(planes).to(torch.bfloat16),
                                           torch.from_numpy(table.reshape(-1)),
                                           torch.from_numpy(uv), PSPEC, blockdiag).numpy()
        want = np.zeros_like(got)
        for t in range(TILES):
            for row in range(got.shape[1]):
                g0, s = (row // sg, row % sg) if blockdiag else (0, row)
                for q in range(3):
                    p = min(max(int(table[t, q, 0]), 0), 2)
                    for g in ((g0,) if blockdiag else range(kg)):
                        ou, ov = int(table[t, q, 1 + 2 * g]), int(table[t, q, 2 + 2 * g])
                        uc = min(max(f32(uvt[t, q, g, 0, s] - f32(ou)), f32(0)), f32(wu - 1.001))
                        if blockdiag:
                            uc = f32(uc + f32(g * wu))
                        fi = np.floor(uc)
                        w0, w1 = (bf16(max(f32(1) - abs(f32(r - uc)), f32(0)))
                                  for r in (fi, f32(fi + 1)))
                        r0 = min(max(ou + int(fi) - (g * wu if blockdiag else 0), 0), rows - 2)
                        c0 = min(max(ov, 0), rv - 8) * 16
                        a0 = planes[p, r0, c0:c0 + 128]
                        a1 = planes[p, r0 + 1, c0:c0 + 128]
                        want[t, row] = want[t, row] + ((w0 * a0).astype(f32)
                                                       + (w1 * a1).astype(f32))
        np.testing.assert_array_equal(got, want)


def test_s1_block_fits_shared_memory(inputs):
    """S1's block (csrc/sampler_stages.cu s1_smem: each warp's 32 step
    records, then two buffers of a tile's job table and u rows) takes 58,240
    B at prof_r5m's spec (16×8 tiles, k 16, kg 4), which fits a block's
    232,448 B; 256 rays × 64 samples in 8 groups do not, and the wrapper
    refuses them before a launch, before it even looks at the operands."""
    import dataclasses

    spec = psamp.SamplerSpec(resolution=prof_r5k.R, channels=prof_r5k.C, tile_w=16, tile_h=8,
                             k=16, kg=4, wu=64, wv=32)
    assert sampler_stages.m1_smem_bytes(spec) == 58240 <= psamp.SMEM_LIMIT
    big = dataclasses.replace(spec, tile_w=32, k=64, kg=8)
    assert sampler_stages.m1_smem_bytes(big) > psamp.SMEM_LIMIT
    scal, uv, _, _, _, planes = inputs
    before = sampler_stages.m1_launches
    with pytest.raises(ValueError, match="shared memory"):
        sampler_stages.m1_only_cuda(torch.from_numpy(planes).to(torch.bfloat16),
                                    torch.from_numpy(scal), torch.from_numpy(uv), big)
    assert sampler_stages.m1_launches == before


@pytest.mark.parametrize("kernel,source", [("S1", "sampler_stages.cu"), ("K2d", "sampler.cu")])
def test_prof_fetch_probes_find_their_text(kernel, source):
    """prof_fetch's probes are text edits of csrc/sampler_stages.cu,
    csrc/sampler.cu and csrc/sampler_core.cuh: each edit's text must be in
    its file as often as the probe says, or the script refuses to build the
    probe on the card. This tree holds the resident-grid design."""
    from mere_fusion_tpu_torch.scripts import prof_fetch

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(psamp.__file__))))
    texts = prof_fetch.read_csrc(root)
    found = prof_fetch.probes(kernel, texts)
    assert {"kernel", "no_stores", "wb_stores",
            "no_texels" if kernel == "S1" else "no_gathers"} <= set(found)
    for edits in found.values():
        text = prof_fetch.edited(texts, source, edits)[source]    # raises if a text is missing
        assert "mf_sections" not in text and "mf_sample_shade_comp" not in text
