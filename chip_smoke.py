#!/usr/bin/env python3
"""Drive the PyTorch port (mere_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line with
its seconds; any failure is fatal (exit code 1, no result line):

1. build    — build kernels K1 (csrc/attention.cu) and K2 (csrc/sampler.cu)
              with nvcc for sm_90a, one nvcc each, started together.
2. kernels  — K1 at the serving shape [16, 8, 1024, 40] in float32 (TF32
              off) and bfloat16 against its plain PyTorch version: max abs
              error, kernel / plain / SDPA times, the bound; a ragged shape
              must raise. K2 on the dense 512² job set (2048 tiles of 16×8
              rays × 16 samples, planned by the port's planner from a
              synthetic pose, seeded random planes and weights) with bf16
              and float32 shade weights against its plain version: max abs
              error, kernel / plain times, the bound; the plain version
              without the bf16 rounding of activations must fail the
              tolerance; a wrong shape must raise.
3. model    — a full-width MuseModels (float32, TF32 off): generate with
              ATTN_IMPL "auto" (K1) against "plain" on the same inputs;
              faces within 1 LSB, UNet output within 1e-4 relative, and
              exactly 5 K1 launches per generate.
4. session  — the port's aiohttp app in-process, MuseTalk, procedural TTS,
              loopback transport, bf16, batch 16: start a session, talk,
              wait for 32 generated frames, stop. Kernel counts are zeroed
              just before and read just after; K1 must have launched.
5. nerf_model   — one full-width ER-NeRF frame (12 hash levels, 1024² bf16
              baked planes, 512² frame, dense 128³ grid, seeded random
              weights) through make_render_step with K2 against the plain
              step on the same inputs: frames within 1 LSB, exactly one K2
              launch per frame; frame times in turns; one frame under
              torch.profiler.
6. nerf_session — the aiohttp app in-process with avatar.kind ernerf, a
              synthesized 512² dataset in a temporary directory, procedural
              TTS, loopback transport: start a session, talk, wait for 50
              rendered frames, stop. Kernel counts are zeroed just before
              and read just after; K2 launches must equal the nerf.render
              observations.

Then the card's name and power limit as nvidia-smi gives them, the
per-kernel JSON line, and last {"ok": true, "device": {...}}. Exits non-zero
without a result when no CUDA device is visible or the package is missing.
"""
from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time
import traceback

SERVE_SHAPE = (16, 8, 1024, 40)   # batch 16 × 8 heads, 32² latents, head_dim 40
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor rate
PEAK_F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
# K2 against its plain version, both dtypes of shade weights: the largest
# error read on the dense job set is 3e-7 (f32 sums in another order), and
# the plain version without the bf16 rounding of activations is further off
# than this limit on the same inputs, which the check asserts.
K2_ATOL = {"float32": 1e-5, "bfloat16": 1e-5}
NERF_HW = 512


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for softmax(q kᵀ/√d) v: each of q, k, v, o moved once vs
    the two products at the card's peak for the dtype."""
    import torch

    b, h, l, d = shape
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * torch.finfo(dtype).bits / 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_generate(fn, kernel: str = "attention_kernel") -> dict:
    """torch.profiler over one call: device time by kernel (top 6), the
    device's busy share of the call's wall time, and the device time of the
    rows whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): CPU op rows repeat their
    # children's device time
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms in rows)
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    kernel_ms = sum(ms for key, ms in rows if kernel in key)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, f"{kernel}_ms": kernel_ms,
            "top": [[key[:80], ms] for key, ms in top]}


def phase_build(state: dict) -> dict:
    from concurrent.futures import ThreadPoolExecutor

    from mere_fusion_tpu_torch.ops import attention, sampler

    with ThreadPoolExecutor(2) as pool:   # one nvcc per source, together
        paths = dict(zip(("K1", "K2"), pool.map(lambda m: m.build(), (attention, sampler))))
    out = {}
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            notes = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        out[name] = {"library": path, "ptxas": notes[:8]}
    return out


def phase_kernels(state: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparisons in true f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = attention.self_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention.self_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= ATOL[name]:
            raise AssertionError(f"K1 {name} max abs err {err} > {ATOL[name]}")
        bound, by = attention_bound_ms(SERVE_SHAPE, dtype)
        out[name] = {
            "max_abs_err": err, "tol": ATOL[name],
            "kernel_ms": time_ms(lambda: attention.self_attention(q, k, v)),
            "plain_ms": time_ms(lambda: attention.self_attention_plain(q, k, v)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": bound, "bound_by": by,
        }
    ragged = torch.zeros((1, 1, 300, 40), device="cuda")
    try:
        attention.self_attention(ragged, ragged, ragged)
    except ValueError as e:
        out["ragged_raises"] = str(e)
    else:
        raise AssertionError("K1 accepted a ragged sequence length")
    state["kernel_numbers"] = out["bfloat16"]
    out["K2"] = k2_check(state)
    return out


def k2_operands(dev, hw: int, spec, wdtype, seed: int = 0):
    """K2's operands for one dense frame: a camera 1.5 from the origin
    looking at a fully occupied box (every ray valid), planned by the
    port's own planner, with seeded random planes and network weights."""
    import torch

    from mere_fusion_tpu_torch.engines.nerf_step import shade_weights
    from mere_fusion_tpu_torch.models.ernerf.network import (
        NeRFNetConfig,
        NeRFNetwork,
        init_ernerf_,
    )
    from mere_fusion_tpu_torch.models.ernerf.renderer import (
        DensityGrid,
        get_rays,
        intersect_aabb,
        select_occupied_depths,
    )
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.ops.encoders import sh_encode

    gen = torch.Generator(device="cpu").manual_seed(seed)
    r = spec.resolution
    planes = {n: (torch.rand(r * r, spec.channels, generator=gen) * 2 - 1).to(dev)
              for n in ("plane_xy", "plane_yz", "plane_xz")}
    planes_major = sampler.pack_planes_major(planes, spec)
    pose = torch.eye(4, device=dev)
    pose[2, 3] = 1.5
    fl = hw * 1.2
    rays_o, rays_d = get_rays(pose, (fl, fl, hw / 2, hw / 2), hw, hw)
    near, far, ok = intersect_aabb(rays_o, rays_d, 1.0)
    dens = DensityGrid.create(16, device=dev)
    z, _, valid = select_occupied_depths(rays_o, rays_d, near, far, dens, 1.0, 16, 32, 2)
    tile = lambda x: sampler.to_tiles(x, hw, hw, spec.tile_w, spec.tile_h)
    va = tile(valid.any(-1) & ok)
    zmin, zmax = tile(z[:, 0]), tile(z[:, -1])
    zmax = zmin + (zmax - zmin) * va.float()
    o_t, d_t = tile(rays_o), tile(rays_d)
    scalars, uv, _ = sampler.plan_jobs_span(o_t, d_t, zmin, zmax, va, spec, 1.0)
    t = o_t.shape[0]
    net = init_ernerf_(NeRFNetwork(NeRFNetConfig(num_levels=spec.channels)).to(dev), seed)
    enc_a = torch.randn(1, 32, generator=gen).to(dev)
    with torch.no_grad():
        weights = shade_weights(net, spec, enc_a, net.individual_code(0),
                                torch.full((1, 1), 0.3, device=dev), wdtype)
        dproj = (sh_encode(d_t.reshape(-1, 3)).reshape(t, -1, 16)
                 @ net.color_net.layer(0).weight.T[:16]).to(wdtype)
    dtv = torch.nn.functional.pad(((zmax - zmin) / spec.k)[..., None], (0, 7))
    return (planes_major, scalars.reshape(-1).contiguous(),
            uv.reshape(t * 3, spec.kg, 2, spec.sg).contiguous(), dproj.contiguous(),
            dtv.contiguous(), weights)


def k2_ops_per_sample(spec) -> int:
    """One sample's operations in K2: the head's multiply-adds twice
    (x·[Wa|Ws|We] over the 3 planes' real channels, aud_ch, aud→sigma, eye,
    sigma 1, sigma 2 with geo, colour 0, rgb) plus 9 per real channel of the
    bilinear sample. The zero lanes that pad each texel to CP are not work."""
    head_macs = (3 * spec.channels * 144 + 64 * 32 + 32 * 64 + 16 + 64 * 64 + 64 * 65
                 + 64 * 64 + 64 * 3)
    return 2 * head_macs + 3 * spec.channels * 9


def k2_bound_ms(spec, ops) -> tuple[float, str]:
    """Least time for K2's work on these operands: every sample's operations
    at the bf16 tensor rate (the head's operands are bf16) against each
    operand read once, the whole plane stack included, and the output
    written once."""
    tiles = ops[2].shape[0] // 3
    samples = tiles * spec.rays_per_tile * spec.k
    nbytes = sum(x.numel() * x.element_size() for x in ops[:5])
    nbytes += sum(w.numel() * w.element_size() for w in ops[5].values())
    nbytes += tiles * spec.rays_per_tile * 16 * 4
    t_ops = samples * k2_ops_per_sample(spec) / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k2_spec():
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.ops.sampler import SamplerSpec

    nc = Config().nerf
    return SamplerSpec(resolution=min(1024, 2 * nc.desired_resolution),
                       channels=nc.num_levels * nc.level_dim, tile_w=nc.pallas_tile_w,
                       tile_h=nc.pallas_tile_h, k=nc.max_steps, kg=nc.pallas_depth_groups,
                       wu=nc.pallas_window_u, wv=nc.pallas_window_v)


def k2_check(state: dict) -> dict:
    import torch

    from mere_fusion_tpu_torch.ops import sampler

    dev = torch.device("cuda", 0)
    spec = k2_spec()
    out = {"tiles": NERF_HW * NERF_HW // spec.rays_per_tile,
           "samples": NERF_HW * NERF_HW * spec.k}
    for wdtype in (torch.bfloat16, torch.float32):
        name = str(wdtype).split(".")[1]
        ops = k2_operands(dev, NERF_HW, spec, wdtype)
        got = sampler.sample_shade_comp_tiles(*ops, spec)
        torch.cuda.synchronize()
        ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
        err = (got - ref).abs().max().item()
        if not err <= K2_ATOL[name]:
            raise AssertionError(f"K2 {name} max abs err {err} > {K2_ATOL[name]}")
        if not bool(torch.isfinite(got).all()) or float(ref[..., 0].min()) <= 0:
            raise AssertionError("K2 output not finite or rays not occupied")
        control = {}
        if wdtype == torch.bfloat16:   # the limit must catch a dropped rounding
            unrounded = sampler.sample_shade_comp_tiles_plain(
                *ops[:5], {k: w.float() for k, w in ops[5].items()}, spec)
            control = {"unrounded_err": (unrounded - ref).abs().max().item()}
            if not control["unrounded_err"] > K2_ATOL[name]:
                raise AssertionError(f"K2 tolerance {K2_ATOL[name]} passes the plain version "
                                     f"without bf16 rounding ({control['unrounded_err']})")
            del unrounded
        bound, by = k2_bound_ms(spec, ops)
        out[name] = {
            "max_abs_err": err, "tol": K2_ATOL[name], **control,
            "weights_sum_mean": float(ref[..., 0].mean()),
            "kernel_ms": time_ms(lambda: sampler.sample_shade_comp_tiles(*ops, spec),
                                 iters=10, warmup=2),
            "plain_ms": time_ms(lambda: sampler.sample_shade_comp_tiles_plain(*ops, spec),
                                iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by,
        }
    planes, jobs, uv, dproj, dtv, weights = ops
    try:
        sampler.sample_shade_comp_tiles(planes, jobs, uv[:-3], dproj, dtv, weights, spec)
    except ValueError as e:
        out["wrong_shape_raises"] = str(e)
    else:
        raise AssertionError("K2 accepted a uv of the wrong shape")
    del ops, planes, jobs, uv, dproj, dtv, weights, got, ref
    torch.cuda.empty_cache()
    state["k2_numbers"] = out["bfloat16"]
    return out


def phase_model(state: dict) -> dict:
    import numpy as np
    import torch

    import mere_fusion_tpu_torch.models.musetalk.unet as unet_mod
    from mere_fusion_tpu_torch.engines.muse import MuseModels
    from mere_fusion_tpu_torch.models.musetalk import positional_encoding
    from mere_fusion_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    models = MuseModels(dtype=torch.float32, device=dev, vae_int8="off")
    rng = np.random.default_rng(0)
    b, s = 16, models.latent_size
    lat = torch.from_numpy(rng.standard_normal((b, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(
        rng.standard_normal((b, 50, models.unet_cfg.cross_attention_dim))
        .astype(np.float32)).to(dev)
    faces, preds, launches = {}, {}, {}
    try:
        for impl in ("plain", "auto"):
            unet_mod.ATTN_IMPL = impl
            before = attention.launches
            faces[impl] = models.generate(lat, feats).cpu().numpy()
            launches[impl] = attention.launches - before
            with torch.no_grad():
                preds[impl] = models.unet(
                    lat.permute(0, 3, 1, 2), torch.zeros(b, device=dev),
                    positional_encoding(feats)).float().cpu().numpy()
    finally:
        unet_mod.ATTN_IMPL = "auto"
    lsb = int(np.abs(faces["auto"].astype(int) - faces["plain"].astype(int)).max())
    rel = float(np.abs(preds["auto"] - preds["plain"]).max()
                / max(1e-12, float(np.abs(preds["plain"]).max())))
    unsaturated = float(((faces["plain"] > 0) & (faces["plain"] < 255)).mean())
    if faces["auto"].shape != (b, models.face_size, models.face_size, 3):
        raise AssertionError(f"faces shape {faces['auto'].shape}")
    if not np.isfinite(preds["auto"]).all():
        raise AssertionError("UNet output is not finite")
    if lsb > 1 or rel > 1e-4:
        raise AssertionError(f"auto vs plain: faces differ by {lsb} LSB, UNet rel {rel}")
    if launches != {"plain": 0, "auto": 5}:
        raise AssertionError(f"K1 launches per generate {launches}, want plain 0, auto 5")
    # the whole step with and without K1, in turns (plain, auto, auto, plain)
    times = {}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            models.unet.to(dtype)
            models.vae.to(dtype)
            models.dtype = dtype
            name = str(dtype).split(".")[1]
            for impl in ("plain", "auto", "auto", "plain"):
                unet_mod.ATTN_IMPL = impl
                ms = time_ms(lambda: models.generate(lat, feats), iters=5, warmup=1)
                times.setdefault(f"generate_{name}_{impl}_ms", []).append(ms)
    finally:
        unet_mod.ATTN_IMPL = "auto"
    profile = profile_generate(lambda: models.generate(lat, feats))
    del models
    torch.cuda.empty_cache()
    return {"bf16_generate_profile": profile,
            "faces_max_lsb": lsb, "unet_max_rel": rel, "unsaturated_share": unsaturated,
            "k1_launches_per_generate": launches["auto"], "batch": b, "dtype": "float32",
            **times}


async def _session(state: dict) -> dict:
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    cfg = Config().override(**{
        "avatar.kind": "musetalk", "avatar.dtype": "bfloat16", "avatar.batch_size": 16,
        "avatar.vae_int8": "off", "tts.backend": "procedural",
        "transport.mode": "loopback", "server.max_sessions": 1})
    engines = []

    def factory(c, **kw):
        from mere_fusion_tpu_torch.engines.muse import MuseModels, synthesize_muse_avatar

        device = kw["device"]
        models = MuseModels(dtype=torch.bfloat16, device=device, vae_int8="off")
        engine = make_engine(c, models=models, avatar=synthesize_muse_avatar(models, 8),
                             **kw)
        engines.append(engine)
        return engine

    def counter(name: str) -> float:
        return metrics.snapshot()["counters"].get(name, 0.0)

    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    attention.launches = sampler.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    try:
        r = await client.post("/start_session", json={})
        body = await r.json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        start_frames = counter("muse.generated_frames")
        for text in ("hello there, this is the musetalk port speaking",
                     "on an nvidia card through a hand written attention kernel",
                     "and this third sentence keeps the mouth moving a while"):
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": text})
            if (await r.json()).get("code") != 0:
                raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while counter("muse.generated_frames") < start_frames + 32:
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"only {counter('muse.generated_frames')} generated frames in 180 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        frame = engines[0].latest_frame
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
    finally:
        await client.close()
    launches = attention.launches              # ... and ends here
    if launches == 0:
        raise AssertionError("K1 never launched during the session")
    if sampler.launches:
        raise AssertionError("K2 launched in the MuseTalk session")
    if frame is None or frame.image.shape != engines[0].avatar.frame_cycle[0].shape:
        raise AssertionError("no emitted frame of the avatar's shape")
    lat = {k: metrics.latency(k) for k in ("muse.infer_batch", "muse.featurize",
                                            "muse.first_frame")}
    infer_p50 = lat["muse.infer_batch"].quantile(0.5)
    state["session_launches"] = launches
    return {
        "generated_frames": counter("muse.generated_frames"),
        "k1_launches": launches,
        "session_build_s": t_started - t0,
        "talk_to_32_frames_s": t_frames - t_started,
        "infer_batch_p50_ms": infer_p50 * 1e3,
        "infer_batch_n": lat["muse.infer_batch"].count,
        "featurize_p50_ms": lat["muse.featurize"].quantile(0.5) * 1e3,
        "first_frame_ms": lat["muse.first_frame"].quantile(0.5) * 1e3,
        "generated_fps_at_p50": 16 / infer_p50 if infer_p50 else None,
        "batch": 16, "dtype": "bfloat16",
    }


def phase_session(state: dict) -> dict:
    return asyncio.run(_session(state))


def nerf_dataset(n_frames: int = 8):
    """A synthesized 512² ER-NeRF pose track in a temporary directory: a
    short orbit 1.5 from the origin, so the box fills every pixel."""
    import tempfile

    from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset

    d = synthesize_nerf_dataset(tempfile.mkdtemp(prefix="chip_smoke_nerf_"),
                                n_frames=n_frames, hw=NERF_HW)
    return f"{d}/transforms.json", f"{d}/au.csv"


def nerf_config(pose_path: str, au_path: str):
    from mere_fusion_tpu_torch.config import Config

    return Config().override(**{
        "avatar.kind": "ernerf", "tts.backend": "procedural", "transport.mode": "loopback",
        "server.max_sessions": 1, "nerf.pose_path": pose_path, "nerf.au_path": au_path,
        "nerf.scale": 1.0})


def phase_nerf_model(state: dict) -> dict:
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.data.provider import NeRFTestDataset
    from mere_fusion_tpu_torch.engines.nerf import net_config
    from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork, init_ernerf_
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.ops import sampler
    from mere_fusion_tpu_torch.ops.triplane_bake import bake_triplanes

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pose_path, au_path = nerf_dataset(4)
    cfg = nerf_config(pose_path, au_path)
    nc = cfg.nerf
    ds = NeRFTestDataset.load(pose_path, au_path, scale=nc.scale)
    net = init_ernerf_(NeRFNetwork(net_config(cfg)).to(dev), 0)
    with torch.no_grad():   # tables of trained magnitude, so the frame has structure
        gen = torch.Generator(device=dev).manual_seed(1)
        for n in ("plane_xy", "plane_yz", "plane_xz"):
            getattr(net, n).uniform_(-1, 1, generator=gen)
    t0 = time.perf_counter()
    baked = bake_triplanes({n: getattr(net, n) for n in ("plane_xy", "plane_yz", "plane_xz")},
                           net.cfg.plane_spec, nc.bound, resolution=min(1024, 2 * nc.desired_resolution),
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    steps = {impl: make_render_step(net, ds, cfg, baked, impl=impl) for impl in ("plain", "auto")}
    dens = DensityGrid.create(nc.grid_size, device=dev)
    bg = torch.ones(NERF_HW * NERF_HW, 3, device=dev)
    auds = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, nc.audio_in_dim, 16)).astype(np.float32)).to(dev)
    eye = ds.collate(0)["eye"]

    def frame(impl):
        return steps[impl](ds.poses[0], auds, eye, dens, bg, pose_key=0)

    frames, launches, stats = {}, {}, {}
    for impl in ("plain", "auto"):
        before = sampler.launches
        img, n_active, n_overflow = frame(impl)
        torch.cuda.synchronize()
        launches[impl] = sampler.launches - before
        frames[impl] = img.cpu().numpy()
        stats[impl] = (int(n_active), int(n_overflow))
    lsb = int(np.abs(frames["auto"].astype(int) - frames["plain"].astype(int)).max())
    if frames["auto"].shape != (NERF_HW, NERF_HW, 3):
        raise AssertionError(f"frame shape {frames['auto'].shape}")
    if lsb > 1:
        raise AssertionError(f"K2 frame differs from the plain frame by {lsb} LSB")
    if launches != {"plain": 0, "auto": 1}:
        raise AssertionError(f"K2 launches per frame {launches}, want plain 0, auto 1")
    if stats["auto"] != stats["plain"] or float(frames["auto"].std()) <= 2:
        raise AssertionError(f"frame stats {stats}, std {frames['auto'].std()}")
    times = {}
    for impl in ("plain", "auto", "auto", "plain"):
        ms = time_ms(lambda: frame(impl), iters=5, warmup=1)
        times.setdefault(f"frame_{impl}_ms", []).append(ms)
    profile = profile_generate(lambda: frame("auto"), kernel="sample_shade_comp")
    del steps, baked, net
    torch.cuda.empty_cache()
    return {"frames_max_lsb": lsb, "k2_launches_per_frame": launches["auto"],
            "active_tiles": stats["auto"][0], "overflow_jobs": stats["auto"][1],
            "unsaturated_share": float(((frames["plain"] > 0) & (frames["plain"] < 255)).mean()),
            "bake_s": bake_s, "frame_profile": profile, **times}


async def _nerf_session(state: dict) -> dict:
    import torch
    from aiohttp.test_utils import TestClient, TestServer

    from mere_fusion_tpu_torch.engines import make_engine
    from mere_fusion_tpu_torch.ops import attention, sampler
    from mere_fusion_tpu_torch.runtime.metrics import metrics
    from mere_fusion_tpu_torch.server.app import create_app

    cfg = nerf_config(*nerf_dataset(8))
    engines = []

    def factory(c, **kw):
        engines.append(make_engine(c, **kw))
        return engines[-1]

    render = metrics.latency("nerf.render")
    client = TestClient(TestServer(create_app(cfg, factory)))
    await client.start_server()
    sampler.launches = attention.launches = 0   # the main path starts here
    renders0 = render.count
    t0 = time.perf_counter()
    try:
        body = await (await client.post("/start_session", json={})).json()
        if body.get("code") != 0:
            raise AssertionError(f"/start_session: {body}")
        sid = body["session_id"]
        t_started = time.perf_counter()
        for text in ("hello there, this is the nerf port speaking",
                     "on an nvidia card through a hand written sampling kernel",
                     "and this third sentence keeps the head talking a while"):
            r = await client.post("/talk", json={"session_id": sid, "type": "echo",
                                                 "text": text})
            if (await r.json()).get("code") != 0:
                raise AssertionError("/talk failed")
        deadline = time.perf_counter() + 180
        while render.count < renders0 + 50:
            if time.perf_counter() > deadline:
                raise AssertionError(f"only {render.count - renders0} frames in 180 s")
            await asyncio.sleep(0.05)
        t_frames = time.perf_counter()
        frame = engines[0].latest_frame
        r = await client.post("/stop_session", json={"session_id": sid})
        if (await r.json()).get("code") != 0:
            raise AssertionError("/stop_session failed")
    finally:
        await client.close()
    launches, renders = sampler.launches, render.count - renders0   # ... and ends here
    if launches < 50 or launches != renders:
        raise AssertionError(f"K2 launched {launches} times for {renders} rendered frames")
    if attention.launches:
        raise AssertionError("K1 launched in the ER-NeRF session")
    if frame is None or frame.image.shape != (NERF_HW, NERF_HW, 3):
        raise AssertionError("no emitted frame of the dataset's shape")
    gauges = metrics.snapshot()["gauges"]
    p50 = render.quantile(0.5)
    state["nerf_session_launches"] = launches
    del engines
    torch.cuda.empty_cache()
    return {
        "rendered_frames": renders, "k2_launches": launches,
        "session_build_s": t_started - t0, "talk_to_50_frames_s": t_frames - t_started,
        "render_p50_ms": p50 * 1e3, "render_fps_at_p50": 1 / p50 if p50 else None,
        "first_frame_ms": metrics.latency("nerf.first_frame").quantile(0.5) * 1e3,
        "active_tiles": gauges.get("nerf.active_tiles"),
        "overflow_jobs": gauges.get("nerf.overflow_jobs"),
        "dropped_tiles": gauges.get("nerf.dropped_tiles"),
    }


def phase_nerf_session(state: dict) -> dict:
    return asyncio.run(_nerf_session(state))


PHASES = (("build", phase_build), ("kernels", phase_kernels), ("model", phase_model),
          ("session", phase_session), ("nerf_model", phase_nerf_model),
          ("nerf_session", phase_nerf_session))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import mere_fusion_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a mere-fusion-tpu checkout "
              "(mere_fusion_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    gpu = card()
    state: dict = {}
    for name, fn in PHASES:
        t0 = time.perf_counter()
        try:
            result = fn(state)
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "seconds": time.perf_counter() - t0})
            return 1
        emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0,
              "card": gpu, **result})
    k1, k2 = state["kernel_numbers"], state["k2_numbers"]
    print(gpu, flush=True)
    emit({"kernels": [{
        "name": "self_attention (K1)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/attention.cu",
        "replaces": "mere_fusion_tpu/ops/attention.py:49",
        "launches": state["session_launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
    }, {
        "name": "sample_shade_comp_tiles (K2)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/sampler.cu",
        "replaces": "mere_fusion_tpu/ops/pallas_sampler.py:670",
        "launches": state["nerf_session_launches"], "max_abs_err": k2["max_abs_err"],
        "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        # no single PyTorch call computes K2's function
        "bound_by": k2["bound_by"], "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
