"""ER-NeRF training CLI of the PyTorch port: the reference recipe's head
stage, its patch and lips fine-tuning, the torso stage and evaluation.

    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --iters 100000 \\
        --workspace trial_obama
    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --iters 125000 \\
        --workspace trial_obama --finetune_lips --patch_size 32
    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --workspace trial_obama --test
    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --iters 100000 \\
        --workspace trial_obama_torso --torso --head_ckpt trial_obama

Data dir format: transforms.json + gt_imgs/ + aud.npy + au.csv (+ parsing/,
+ <img_id>.lms landmarks under ori_imgs/ or gt_imgs/ for --finetune_lips,
+ torso_imgs/ for the torso stage). Runs on the current CUDA device unless
``--device cpu``. Each head iteration trains on one random frame's ray
batch (with ``--patch_size``, square patches and a 0.1 × LPIPS term; with
``--finetune_lips``, every odd iteration the static lips window and a 0.01 ×
LPIPS term) and refreshes the density grid every 16 iterations; a rerun
with the same workspace resumes from its latest checkpoint, as the
reference's two-stage recipe does. ``--viewer_port`` serves the training
viewer (train/viewer.py) during the run. ``--test`` renders every frame from
the workspace's EMA weights and writes PSNR and SSIM to its eval.json.
``--torso`` trains only the torso nets on one random frame's torso batch an
iteration, with the head's raw parameters and density grid loaded from the
``--head_ckpt`` workspace (the port's, or the JAX package's orbax one) and
frozen; it starts afresh each run, as the JAX
CLI does. Both stages checkpoint ``ckpt-<step>.pt`` into their workspace,
which ``nerf.ckpt`` serves. LPIPS runs with seeded random weights unless
``--lpips_alex`` and ``--lpips_lins`` name torchvision's AlexNet and the
lpips package's lin heads.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("ernerf-train")
    p.add_argument("data_dir")
    p.add_argument("--workspace", default="workspace")
    p.add_argument("--iters", type=int, default=200_000)
    p.add_argument("--num_rays", type=int, default=65536 // 16)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--lr_net", type=float, default=5e-4)
    p.add_argument("--grid_size", type=int, default=128)
    p.add_argument("--audio_dim", type=int, default=44)
    p.add_argument("--num_levels", type=int, default=12)
    p.add_argument("--base_resolution", type=int, default=64)
    p.add_argument("--desired_resolution", type=int, default=512)
    p.add_argument("--log2_hashmap_size", type=int, default=14)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=4.0,
                   help="scale of camera positions into the [-bound, bound]^3 box (the "
                        "upstream ER-NeRF main.py's --scale; a serving config's nerf.scale "
                        "must match)")
    p.add_argument("--preload", type=int, default=1, choices=(0, 1, 2),
                   help="dataset tier: 0 disk-lazy, 1 host RAM, 2 device-resident frames")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' to run "
                        "on the CPU)")
    p.add_argument("--patch_size", type=int, default=0,
                   help="sample NxN pixel patches and add the 0.1 x LPIPS patch loss")
    p.add_argument("--lpips_alex", default=None,
                   help="torchvision alexnet .pth for the LPIPS backbone")
    p.add_argument("--lpips_lins", default=None,
                   help="lpips package lin-head .pth (alex.pth)")
    p.add_argument("--finetune_lips", action="store_true",
                   help="lips fine-tuning: every odd iteration a step on the static lips "
                        "window with a 0.01 x LPIPS loss")
    p.add_argument("--lips_size", type=int, default=64,
                   help="side of the static lips window")
    p.add_argument("--test", action="store_true",
                   help="evaluation: render every training frame from the workspace's EMA "
                        "weights and write PSNR/SSIM to <workspace>/eval.json")
    p.add_argument("--viewer_port", type=int, default=None,
                   help="serve the training viewer on this port (0 = any free port): "
                        "MJPEG /preview of the in-flight weights, POST /camera, /stats")
    p.add_argument("--viewer_size", type=int, default=256,
                   help="training-viewer render resolution")
    p.add_argument("--torso", action="store_true",
                   help="torso stage: train only the torso nets against torso_imgs/, "
                        "the head loaded from --head_ckpt and frozen")
    p.add_argument("--head_ckpt", default="",
                   help="workspace of the trained head stage to load and freeze (or a "
                        "converted dir; the JAX package's orbax workspace needs tensorstore)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np

    from mere_fusion_tpu_torch.data.provider import NeRFTrainDataset
    from mere_fusion_tpu_torch.device import resolve_device
    from mere_fusion_tpu_torch.models.ernerf.network import (
        NeRFNetConfig,
        NeRFNetwork,
        init_ernerf_,
    )
    from mere_fusion_tpu_torch.train.ernerf_train import (
        NeRFTrainConfig,
        init_nerf_train,
        make_nerf_train_step,
        refresh_density_grid,
    )
    from mere_fusion_tpu_torch.train.logger import ScalarLogger, StopFlag
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    device = resolve_device(args.device)
    dataset = NeRFTrainDataset.load(args.data_dir, scale=args.scale, preload=args.preload,
                                    device=device)
    print(f"[train] {len(dataset)} frames, {dataset.H}x{dataset.W}, on {device}")

    net_cfg = NeRFNetConfig(
        audio_in_dim=args.audio_dim, num_train_frames=len(dataset), torso=args.torso,
        num_levels=args.num_levels, base_resolution=args.base_resolution,
        desired_resolution=args.desired_resolution,
        log2_hashmap_size=args.log2_hashmap_size)
    tcfg = NeRFTrainConfig(grid_size=args.grid_size, iters=args.iters, lr=args.lr,
                           lr_net=args.lr_net)
    if args.test:
        _evaluate(args, dataset, net_cfg, tcfg, device)
        return
    network = init_ernerf_(NeRFNetwork(net_cfg).to(device), args.seed)
    if args.torso:
        _train_torso(args, dataset, network, tcfg, device)
        return
    state = init_nerf_train(network, tcfg)
    lpips_fn = patch_hw = None
    patch_size = args.patch_size or None
    if patch_size or args.finetune_lips:
        from mere_fusion_tpu_torch.models.lpips import make_lpips_fn

        lpips_fn = make_lpips_fn(args.lpips_alex, args.lpips_lins, device=device)
    if patch_size:
        patch_hw = (patch_size, patch_size)
    step = make_nerf_train_step(tcfg, lpips_fn=lpips_fn if patch_size else None,
                                patch_hw=patch_hw)
    lips_step = None
    if args.finetune_lips:
        # the reference's lips steps drop the uncertainty loss (utils.py:789)
        lips_step = make_nerf_train_step(
            dataclasses.replace(tcfg, unc_loss=False), lpips_fn=lpips_fn,
            patch_hw=(args.lips_size, args.lips_size), lpips_weight=0.01)

    ckpt = Checkpointer(args.workspace)
    it0 = 0
    if ckpt.latest_step is not None:
        state.load_state_dict(ckpt.restore(map_location=device))
        it0 = state.step
        print(f"[train] resumed from step {it0}")
    if it0 >= args.iters:
        print(f"[train] checkpoint step {it0} >= --iters {args.iters}; "
              "nothing to do (pass a larger total step target)")
        ckpt.close()
        return

    mean_auds = torch.from_numpy(
        dataset.auds[np.clip(np.arange(8), 0, len(dataset) - 1)]).to(device)
    viewer = None
    if args.viewer_port is not None:
        from mere_fusion_tpu_torch.train.viewer import TrainingViewer

        viewer = TrainingViewer(_make_viewer_render(tcfg, dataset, args.viewer_size),
                                width=args.viewer_size, height=args.viewer_size,
                                port=args.viewer_port)
        print(f"[train] viewer: http://127.0.0.1:{viewer.port}/preview", flush=True)
    noise_gen = torch.Generator(device=device)
    slog = ScalarLogger(args.workspace)
    stop = StopFlag.install()
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    metrics = {"loss": float("nan")}
    it = it0
    try:
        for it in range(it0, args.iters):
            frame = int(rng.integers(0, len(dataset)))
            noise_gen.manual_seed(it)          # the JAX loop's jax.random.key(it)
            if lips_step is not None and it % 2 == 1:
                # a lips step every other iteration, as the reference flips them
                batch = dataset.sample_lips_rays(frame, rng, size=args.lips_size)
                metrics = lips_step(state, batch, generator=noise_gen)
            else:
                batch = dataset.sample_rays(frame, args.num_rays, rng, patch_size=patch_size)
                metrics = step(state, batch, generator=noise_gen)
            if it % 16 == 0:
                refresh_density_grid(state, mean_auds, tcfg)
            if viewer is not None:
                viewer.tick(state, it, metrics)
            if it % 100 == 0:
                loss = float(metrics["loss"])
                rate = (it - it0 + 1) / (time.time() - t0)
                print(f"[train] it {it}  loss {loss:.5f}  {rate:.1f} it/s")
                slog.log(it, loss=loss, mse=float(metrics["mse"]), it_per_s=rate)
            if it > 0 and it % args.ckpt_every == 0:
                ckpt.save(it, state.state_dict(), {"loss": float(metrics["loss"])})
            if stop:
                print(f"[train] stop signal — checkpointing at it {it}")
                break
        ckpt.save(it + 1 if stop else args.iters, state.state_dict(),
                  {"loss": float(metrics["loss"])})
    finally:
        stop.uninstall()
        if viewer is not None:
            viewer.close()
        slog.close()
        ckpt.close()
    print("[train] done")


@torch.no_grad()
def render_image(network, density, tcfg, pose, intrinsics, H: int, W: int, auds, eye):
    """One whole H×W frame of the network on a white background, clipped
    to [0, 1]: pose [4, 4], intrinsics (fx, fy, cx, cy), the audio window
    auds [8, A, 16] and eye [1, 1], frame 0's individual code, the
    training config's sampling. One K3 encode on the card."""
    from mere_fusion_tpu_torch.models.ernerf.renderer import get_rays, render_rays

    enc_a = network.encode_audio(auds)
    ind = network.individual_code(0) if network.cfg.individual_dim > 0 else None
    rays_o, rays_d = get_rays(pose, tuple(float(v) for v in intrinsics), H, W)
    out = render_rays(lambda x, d, tr: network(x, d, enc_a, ind, eye, tr), rays_o, rays_d,
                      density, bound=tcfg.bound, grid_size=tcfg.grid_size,
                      bg_color=torch.ones(3, device=pose.device),
                      n_candidates=tcfg.n_candidates, n_steps=tcfg.n_steps)
    return torch.clamp(out["image"].reshape(H, W, 3), 0.0, 1.0)


def _make_viewer_render(tcfg, dataset, size: int):
    """The training viewer's render closure: the state's current (non-EMA)
    weights and density grid, one size² orbit-camera frame with the
    dataset's first audio window and its mean eye area held fixed, read back
    as numpy. The reference's train GUI likewise renders whatever its loader
    last gave it."""
    import numpy as np

    from mere_fusion_tpu_torch.device import device_scope

    dev = dataset.device
    auds = torch.from_numpy(dataset.auds[np.clip(np.arange(8), 0, len(dataset) - 1)]).to(dev)
    eye = torch.tensor([[float(np.mean(dataset.eye_area))]], dtype=torch.float32, device=dev)

    def render_fn(state, pose, intrinsics):
        # /camera renders on the server's handler threads: pin their device
        with device_scope(dev):
            img = render_image(state.network, state.density, tcfg,
                               torch.from_numpy(np.asarray(pose, np.float32)).to(dev),
                               intrinsics, size, size, auds, eye)
            return img.cpu().numpy()

    return render_fn


def _evaluate(args, dataset, net_cfg, tcfg, device) -> None:
    """Render every frame from the workspace's EMA weights and density grid
    and report PSNR and SSIM into <workspace>/eval.json, as the JAX
    package's --test does (the reference's main.py --test and
    Trainer.evaluate metrics)."""
    import json
    import os

    import numpy as np

    from mere_fusion_tpu_torch.models.ernerf.network import NeRFNetwork
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.train.metrics import MetricMeter, psnr, ssim
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    raw = Checkpointer(args.workspace).restore(map_location=device)
    network = NeRFNetwork(net_cfg).to(device)
    network.load_state_dict({k: v.float() for k, v in raw["ema"].items()}, strict=True)
    density = DensityGrid(**raw["density"])
    m_psnr = MetricMeter(psnr, "PSNR")
    m_ssim = MetricMeter(ssim, "SSIM")
    att = 8
    t0 = time.time()
    for i in range(len(dataset)):
        idx = np.clip(np.arange(i - att // 2, i + att // 2), 0, len(dataset) - 1)
        img = render_image(network, density, tcfg, torch.from_numpy(dataset.poses[i]).to(device),
                           dataset.intrinsics, dataset.H, dataset.W,
                           torch.from_numpy(dataset.auds[idx]).to(device),
                           torch.tensor([[dataset.eye_area[i]]], dtype=torch.float32,
                                        device=device))
        gt = torch.from_numpy(np.asarray(dataset.images[i])).to(device)
        m_psnr.update(img, gt)
        m_ssim.update(img, gt)
    dt = time.time() - t0
    report = {"frames": len(dataset), "psnr": m_psnr.mean, "ssim": float(m_ssim.mean),
              "seconds": round(dt, 1)}
    with open(os.path.join(args.workspace, "eval.json"), "w") as f:
        json.dump(report, f)
    print(f"[test] {m_psnr.report()}  {m_ssim.report()}  "
          f"({len(dataset)} frames in {dt:.1f} s)")


def head_checkpoint(path: str, device) -> tuple[dict, "DensityGrid | None"]:
    """(the head stage's raw parameters as a state dict, its density grid or
    None) on ``device``, from ``--head_ckpt``: the port's workspace (its
    ``network``, not its EMA), a directory tools/convert_ckpt.py wrote, or
    the JAX package's orbax directory, whose ``params`` and ``density`` are
    taken as the JAX CLI takes a head workspace's (reading it needs
    tensorstore)."""
    from mere_fusion_tpu_torch.convert import split_density, state_from_flax
    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.utils.checkpoint import (
        Checkpointer,
        is_converted,
        load_converted,
        restore_orbax_raw,
    )

    workspace = Checkpointer(path)
    if workspace.steps():
        head = workspace.restore(map_location=device)
        return head["network"], DensityGrid(**head["density"])
    if is_converted(path):
        state = load_converted(path)[0]
    else:
        raw = restore_orbax_raw(path)
        state = state_from_flax("ernerf", {k: raw[k] for k in ("params", "density") if k in raw})
    params, density = split_density(state)
    if density is not None:
        density = DensityGrid(**{k: v.to(device) for k, v in vars(density).items()})
    return {k: v.to(device) for k, v in params.items()}, density


def _train_torso(args, dataset, network, tcfg, device) -> None:
    """The torso stage: the head workspace's raw parameters (``network``,
    not its EMA) and trained density grid, the torso trained alone, a
    checkpoint of the whole state in the workspace."""
    import numpy as np

    from mere_fusion_tpu_torch.train.ernerf_train import (
        init_torso_train,
        make_torso_train_step,
    )
    from mere_fusion_tpu_torch.train.logger import ScalarLogger, StopFlag
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    head, density = head_checkpoint(args.head_ckpt, device) if args.head_ckpt else (None, None)
    state = init_torso_train(network, tcfg, head_params=head)
    if density is not None:
        # the head's trained grid rides along (a model buffer in the reference)
        state.density = density
    step = make_torso_train_step()
    ckpt = Checkpointer(args.workspace)
    slog = ScalarLogger(args.workspace)
    stop = StopFlag.install()
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    metrics = {"loss": float("nan")}
    it = 0
    try:
        for it in range(args.iters):
            frame = int(rng.integers(0, len(dataset)))
            metrics = step(state, dataset.sample_torso_rays(frame, args.num_rays, rng))
            if it % 100 == 0:
                loss = float(metrics["loss"])
                rate = (it + 1) / (time.time() - t0)
                print(f"[torso] it {it}  loss {loss:.5f}  {rate:.1f} it/s")
                slog.log(it, loss=loss, mse=float(metrics["mse"]), it_per_s=rate)
            if it > 0 and it % args.ckpt_every == 0:
                ckpt.save(it, state.state_dict(), {"loss": float(metrics["loss"])})
            if stop:
                print(f"[torso] stop signal — checkpointing at it {it}")
                break
        ckpt.save(it + 1 if stop else args.iters, state.state_dict(),
                  {"loss": float(metrics["loss"])})
    finally:
        stop.uninstall()
        slog.close()
        ckpt.close()
    print("[torso] done")


if __name__ == "__main__":
    main()
