"""K1 and the MuseTalk step of several checkouts, in turns, on one card.

    python -m mere_fusion_tpu_torch.scripts.k1_turns PARENT . . PARENT

Each argument is the root of a checkout. Each runs in a process of its own,
in the order given (parent, tree, tree, parent puts drift on both sides),
importing that checkout's ``mere_fusion_tpu_torch`` and measuring it with
this checkout's ``chip_smoke.py``:

- K1 at the serving shape [16, 8, 1024, 40] in bfloat16 and float32
  (TF32 off): kernel, plain and SDPA ms by CUDA events, and the largest
  error against the plain version, absolute and relative to the output's
  largest magnitude;
- a full-width MuseModels generate in bfloat16 (random weights from fixed
  seeds, batch 16): ``chip_smoke.generate_check`` with K1 against the plain
  attention (the faces' LSB, the UNet output's relative difference), the
  generate's ms by CUDA events, and one generate under torch.profiler
  (device ms, busy share, K1's device ms);
- a MuseTalk loopback session (``chip_smoke._session``): muse.infer_batch
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
    spec = importlib.util.spec_from_file_location(
        "k1_turns_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
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
    from mere_fusion_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise RuntimeError("k1_turns measures on a CUDA card; none is visible")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"root": root, "package": os.path.dirname(attention.__file__)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = (torch.randn(SERVE_SHAPE, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        got = attention.self_attention(q, k, v)
        ref = attention.self_attention_plain(q, k, v).float()
        err = (got.float() - ref).abs().max().item()
        out[f"k1_{name}"] = {
            "max_abs_err": err, "rel_err": err / ref.abs().max().item(),
            "kernel_ms": cs.time_ms(lambda: attention.self_attention(q, k, v)),
            "plain_ms": cs.time_ms(lambda: attention.self_attention_plain(q, k, v)),
            "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        }
    dev = torch.device("cuda", 0)
    models = MuseModels(dtype=torch.float32, device=dev, vae_int8="off")
    models.unet.to(torch.bfloat16)
    models.vae.to(torch.bfloat16)
    models.dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    b, s = 16, models.latent_size
    lat = torch.from_numpy(rng.standard_normal((b, s, s, 8)).astype(np.float32)).to(dev)
    feats = torch.from_numpy(
        rng.standard_normal((b, 50, models.unet_cfg.cross_attention_dim))
        .astype(np.float32)).to(dev)
    out["bf16_generate"] = cs.generate_check(models, lat, feats)
    out["bf16_generate"]["ms"] = cs.time_ms(lambda: models.generate(lat, feats),
                                            iters=5, warmup=1)
    out["bf16_generate"]["profile"] = cs.profile_generate(
        lambda: models.generate(lat, feats), kernel="attention_")
    del models
    torch.cuda.empty_cache()
    out["session"] = asyncio.run(cs._session({}))
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
            ("k1_bf16_ms", lambda r: r["k1_bfloat16"]["kernel_ms"]),
            ("k1_bf16_max_abs_err", lambda r: r["k1_bfloat16"]["max_abs_err"]),
            ("sdpa_bf16_ms", lambda r: r["k1_bfloat16"]["library_ms"]),
            ("plain_bf16_ms", lambda r: r["k1_bfloat16"]["plain_ms"]),
            ("k1_f32_ms", lambda r: r["k1_float32"]["kernel_ms"]),
            ("k1_f32_max_abs_err", lambda r: r["k1_float32"]["max_abs_err"]),
            ("generate_bf16_faces_lsb", lambda r: r["bf16_generate"]["faces_max_lsb"]),
            ("generate_bf16_unet_rel", lambda r: r["bf16_generate"]["unet_max_rel"]),
            ("generate_bf16_ms", lambda r: r["bf16_generate"]["ms"]),
            ("generate_bf16_device_ms", lambda r: r["bf16_generate"]["profile"].get("device_ms")),
            ("generate_bf16_k1_device_ms",
             lambda r: r["bf16_generate"]["profile"].get("attention__ms")),
            ("infer_batch_p50_ms", lambda r: r["session"]["infer_batch_p50_ms"]),
            ("infer_batch_n", lambda r: r["session"]["infer_batch_n"])):
        summary[key] = [pick(r) for r in runs]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
