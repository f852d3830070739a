"""K1 in float32, K2, K3's backward and the ER-NeRF frame of several
checkouts, in turns, on one card.

    python -m mere_fusion_tpu_torch.scripts.k2_turns PARENT . . PARENT

Each argument is the root of a checkout. Each runs in a process of its own,
in the order given (parent, tree, tree, parent puts drift on both sides),
importing that checkout's ``mere_fusion_tpu_torch`` and measuring it with
this checkout's ``chip_smoke.py``:

- K1 at the serving shape [16, 8, 1024, 40] in float32 (TF32 off): kernel,
  plain and SDPA ms by CUDA events, and the largest error against the plain
  version, absolute and relative to the output's largest magnitude;
- a full-width MuseModels generate in float32 (random weights from fixed
  seeds, batch 16): its ms by CUDA events and one generate under
  torch.profiler (device ms, busy share, K1's device ms);
- K2 on the dense 512² job set (``chip_smoke.k2_operands``) with bfloat16
  and float32 shade weights: kernel ms by CUDA events and the largest error
  against the plain version;
- K3's backward at the training shape (``chip_smoke.k3_operands``): its
  device ms (torch.profiler, as ``chip_smoke`` times it; a zero fill that a
  checkout's wrapper launches before the kernel is counted with it);
- the ``nerf_model`` frame (``chip_smoke.nerf_frame_model``, the K2 step)
  with bfloat16 and with float32 shade weights (``nerf.shade_dtype``): its
  ms by CUDA events and one frame under torch.profiler (device ms, busy
  share, K2's device ms);
- an ER-NeRF loopback session (``chip_smoke._nerf_session``): nerf.render
  p50 and the other session numbers.

Prints one JSON line per run, the card's name and power limit, and a JSON
summary of each number by run as the last line. Raises without CUDA.
"""
from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SERVE_SHAPE = (16, 8, 1024, 40)


def _chip_smoke():
    """This checkout's chip_smoke.py (the measuring code), whichever
    checkout's package is measured."""
    spec = importlib.util.spec_from_file_location(
        "k2_turns_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    """Every number above for the checkout at ``root`` (already first on
    sys.path): runs in the child process."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mere_fusion_tpu_torch.engines.muse import MuseModels
    from mere_fusion_tpu_torch.engines.nerf_step import make_render_step
    from mere_fusion_tpu_torch.ops import attention, hash_lookup, sampler

    if not torch.cuda.is_available():
        raise RuntimeError("k2_turns measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {"root": root, "package": os.path.dirname(attention.__file__)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda") for _ in range(3))
    ref = attention.self_attention_plain(q, k, v)
    err = (attention.self_attention(q, k, v) - ref).abs().max().item()
    out["k1_f32"] = {
        "max_abs_err": err, "rel_err": err / ref.abs().max().item(),
        "kernel_ms": cs.time_ms(lambda: attention.self_attention(q, k, v)),
        "plain_ms": cs.time_ms(lambda: attention.self_attention_plain(q, k, v)),
        "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
    }
    del q, k, v, ref

    models = MuseModels(dtype=torch.float32, device=dev, vae_int8="off")
    rng = np.random.default_rng(0)
    b, s = 16, models.latent_size
    lat = torch.from_numpy(rng.standard_normal((b, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(
        rng.standard_normal((b, 50, models.unet_cfg.cross_attention_dim))
        .astype(np.float32)).to(dev)
    out["f32_generate"] = {
        "ms": cs.time_ms(lambda: models.generate(lat, feats), iters=5, warmup=1),
        "profile": cs.profile_generate(lambda: models.generate(lat, feats),
                                       kernel="attention_")}
    del models
    torch.cuda.empty_cache()

    spec = cs.k2_spec()
    for wdtype in (torch.bfloat16, torch.float32):
        ops = cs.k2_operands(dev, cs.NERF_HW, spec, wdtype)
        got = sampler.sample_shade_comp_tiles(*ops, spec)
        ref = sampler.sample_shade_comp_tiles_plain(*ops, spec)
        out[f"k2_{str(wdtype).split('.')[1]}"] = {
            "max_abs_err": (got - ref).abs().max().item(),
            "kernel_ms": cs.time_ms(lambda: sampler.sample_shade_comp_tiles(*ops, spec),
                                    iters=10, warmup=2)}
        del ops, got, ref
        torch.cuda.empty_cache()

    spec3, tables, idx, w, gout = cs.k3_operands(dev)
    out["k3_bwd"] = {"device_ms": cs.device_ms(
        lambda: hash_lookup.lookup_bwd_cuda(idx, w, gout, spec3, tables))}
    del tables, idx, w, gout
    torch.cuda.empty_cache()

    cfg, ds, net, baked, _ = cs.nerf_frame_model(dev)
    dens, bg, auds, eye = cs.nerf_frame_inputs(cfg, ds, dev)
    for key, shade_dtype in (("nerf_frame", "bfloat16"), ("nerf_frame_f32", "float32")):
        step = make_render_step(net, ds, cfg.override(**{"nerf.shade_dtype": shade_dtype}),
                                baked, impl="auto")

        def frame():
            return step(ds.poses[0], auds, eye, dens, bg, pose_key=0)

        out[key] = {"ms": cs.time_ms(frame, iters=5, warmup=1),
                    "profile": cs.profile_generate(frame, kernel="sample_shade_comp")}
        del step
    del baked, net
    torch.cuda.empty_cache()
    out["nerf_session"] = asyncio.run(cs._nerf_session({}))
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        root = os.path.abspath(argv[1])
        sys.path.insert(0, root)
        os.chdir(root)
        print(json.dumps(measure(root)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"the run of {root} failed with code {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    summary = {"card": card, "roots": argv}
    for key, pick in (
            ("k1_f32_ms", lambda r: r["k1_f32"]["kernel_ms"]),
            ("sdpa_f32_ms", lambda r: r["k1_f32"]["library_ms"]),
            ("k1_f32_max_abs_err", lambda r: r["k1_f32"]["max_abs_err"]),
            ("generate_f32_ms", lambda r: r["f32_generate"]["ms"]),
            ("generate_f32_device_ms", lambda r: r["f32_generate"]["profile"].get("device_ms")),
            ("generate_f32_k1_device_ms",
             lambda r: r["f32_generate"]["profile"].get("attention__ms")),
            ("k2_bf16_ms", lambda r: r["k2_bfloat16"]["kernel_ms"]),
            ("k2_bf16_max_abs_err", lambda r: r["k2_bfloat16"]["max_abs_err"]),
            ("k2_f32_ms", lambda r: r["k2_float32"]["kernel_ms"]),
            ("k2_f32_max_abs_err", lambda r: r["k2_float32"]["max_abs_err"]),
            ("frame_ms", lambda r: r["nerf_frame"]["ms"]),
            ("frame_device_ms", lambda r: r["nerf_frame"]["profile"].get("device_ms")),
            ("frame_k2_device_ms",
             lambda r: r["nerf_frame"]["profile"].get("sample_shade_comp_ms")),
            ("frame_f32_ms", lambda r: r["nerf_frame_f32"]["ms"]),
            ("frame_f32_device_ms", lambda r: r["nerf_frame_f32"]["profile"].get("device_ms")),
            ("frame_f32_k2_device_ms",
             lambda r: r["nerf_frame_f32"]["profile"].get("sample_shade_comp_ms")),
            ("k3_bwd_device_ms", lambda r: r["k3_bwd"]["device_ms"]),
            ("render_p50_ms", lambda r: r["nerf_session"]["render_p50_ms"]),
            ("rendered_frames", lambda r: r["nerf_session"]["rendered_frames"])):
        summary[key] = [pick(r) for r in runs]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
