"""K5 and MuseTalk's int8 tier of several checkouts, in turns, on one card.

    python -m mere_fusion_tpu_torch.scripts.k5_turns PARENT . . PARENT

Each argument is the root of a checkout. Each runs in a process of its own,
in the order given (parent, tree, tree, parent puts drift on both sides),
importing that checkout's ``mere_fusion_tpu_torch`` and measuring it with
this checkout's ``chip_smoke.py``:

- K5 at each shape of the VAE decode's int8 convs (``chip_smoke.INT8_SHAPES``,
  bf16, batch 16, seeded): ``int8_conv`` against ``int8_conv_plain`` (equal
  or not), the whole ``int8_conv`` call and ``conv_q_cuda`` on shared
  operands (quantize pass and conv), ms by CUDA events;
- a full-width bf16 ``MuseModels(vae_int8="auto")`` (seeded weights): the
  tier the gate keeps; for "off", "full" (the int8 decode) and the kept
  tier, the p50 of ``generate`` and of the VAE decode at batch 16, and one
  decode under torch.profiler (device ms, device launches);
- two MuseTalk loopback sessions (``chip_smoke._session``), on the default
  ``vae_int8`` ("auto") and on "off": muse.infer_batch p50.

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
BATCH = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "k5_turns_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    """Every number above for the checkout at ``root`` (already first on
    sys.path): runs in the child process."""
    import numpy as np
    import torch

    from mere_fusion_tpu_torch.engines.muse import MuseModels
    from mere_fusion_tpu_torch.models.musetalk import positional_encoding
    from mere_fusion_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        raise RuntimeError("k5_turns measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out: dict = {"root": root, "package": os.path.dirname(quant.__file__), "k5": {}}
    for cin, hw, cout, k in cs.INT8_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((BATCH, cin, hw, hw), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((cout, cin, k, k), generator=gen, device=dev)
             / (cin * k * k) ** 0.5).to(torch.bfloat16)
        b = (0.1 * torch.randn((cout,), generator=gen, device=dev)).to(torch.bfloat16)
        ops = quant.int8_operands(x, w)
        out["k5"][cs.k5_shape_name(cin, hw, cout, k)] = {
            "equal": torch.equal(quant.int8_conv(x, w, b, 1, k // 2),
                                 quant.int8_conv_plain(x, w, b, 1, k // 2)),
            "call_ms": cs.time_ms(lambda: quant.int8_conv(x, w, b, 1, k // 2),
                                  iters=10, warmup=2),
            "conv_q_ms": cs.time_ms(lambda: quant.conv_q_cuda(x, *ops, b, 1, k // 2),
                                    iters=10, warmup=2)}
        del x, w, b, ops
        torch.cuda.empty_cache()
    models = MuseModels(dtype=torch.bfloat16, device=dev, vae_int8="auto")
    chosen = out["tier"] = models.int8_tier
    rng = np.random.default_rng(0)
    s = models.latent_size
    lat = torch.from_numpy(rng.standard_normal((BATCH, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(rng.standard_normal(
        (BATCH, 50, models.unet_cfg.cross_attention_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        models.set_int8_tier("off")
        pz = models.unet(lat.permute(0, 3, 1, 2).to(torch.bfloat16),
                         torch.zeros(BATCH, device=dev),
                         positional_encoding(feats)) / models.scaling_factor
    for tier in dict.fromkeys(("off", "full", chosen)):
        models.set_int8_tier(tier)
        with torch.no_grad():
            profiled = cs.device_kernels(lambda: models.vae.decode(pz))
            out[tier] = {
                "generate_ms": cs.p50_ms(lambda: models.generate(lat, feats), iters=10, warmup=2),
                "decode_ms": cs.p50_ms(lambda: models.vae.decode(pz), iters=10, warmup=2),
                "decode_device_ms": "not measured" if profiled is None else
                sum(ms for _, ms in profiled[1].values()),
                "decode_launches": "not measured" if profiled is None else profiled[0]}
    del models, lat, feats, pz
    torch.cuda.empty_cache()
    out["session_auto"] = asyncio.run(cs._session({}, vae_int8=None))
    out["session_off"] = asyncio.run(cs._session({}, vae_int8="off"))
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
    summary = {"card": card, "roots": argv, "tier": [r["tier"] for r in runs]}
    for shape in runs[0]["k5"]:
        for key in ("equal", "call_ms", "conv_q_ms"):
            summary[f"k5 {shape} {key}"] = [r["k5"][shape][key] for r in runs]
    for tier in ("off", "full", "kept"):
        for key in ("generate_ms", "decode_ms", "decode_device_ms", "decode_launches"):
            summary[f"{tier} {key}"] = [r[r["tier"] if tier == "kept" else tier][key]
                                        for r in runs]
    for name in ("session_auto", "session_off"):
        summary[f"{name} infer_batch_p50_ms"] = [r[name]["infer_batch_p50_ms"] for r in runs]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
