#!/usr/bin/env python3
"""Drive the PyTorch port (mere_fusion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one JSON line with
its seconds; any failure is fatal (exit code 1, no result line):

1. build    — build kernel K1 (csrc/attention.cu) with nvcc for sm_90a.
2. kernels  — K1 at the serving shape [16, 8, 1024, 40] in float32 (TF32
              off) and bfloat16 against its plain PyTorch version: max abs
              error, kernel / plain / SDPA times, the bound; a ragged shape
              must raise.
3. model    — a full-width MuseModels (float32, TF32 off): generate with
              ATTN_IMPL "auto" (K1) against "plain" on the same inputs;
              faces within 1 LSB, UNet output within 1e-4 relative, and
              exactly 5 K1 launches per generate.
4. session  — the port's aiohttp app in-process, MuseTalk, procedural TTS,
              loopback transport, bf16, batch 16: start a session, talk,
              wait for 32 generated frames, stop. K1 counts are zeroed just
              before and read just after; K1 must have launched.

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


def profile_generate(fn) -> dict:
    """torch.profiler over one call: device time by kernel (top 6), the
    device's busy share of the call's wall time, and K1's share."""
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
    k1_ms = sum(ms for key, ms in rows if "attention_kernel" in key)
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms, "k1_ms": k1_ms,
            "top": [[key[:80], ms] for key, ms in top]}


def phase_build(state: dict) -> dict:
    from mere_fusion_tpu_torch.ops import attention

    path = attention.build()
    with open(path[:-3] + ".log") as f:
        regs = [ln.strip() for ln in f if "registers" in ln]
    return {"library": path, "ptxas": regs[:2]}


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
    from mere_fusion_tpu_torch.ops import attention
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
    attention.launches = 0                    # the main path starts here
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
    for name, fn in (("build", phase_build), ("kernels", phase_kernels),
                     ("model", phase_model), ("session", phase_session)):
        t0 = time.perf_counter()
        try:
            result = fn(state)
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "ok": False, "seconds": time.perf_counter() - t0})
            return 1
        emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0,
              "card": gpu, **result})
    k = state["kernel_numbers"]
    print(gpu, flush=True)
    emit({"kernels": [{
        "name": "self_attention (K1)", "route": "cuda",
        "source": "mere_fusion_tpu_torch/csrc/attention.cu",
        "replaces": "mere_fusion_tpu/ops/attention.py:49",
        "launches": state["session_launches"], "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
