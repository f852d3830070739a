"""ER-NeRF training CLI of the PyTorch port: the head stage, then the torso.

    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --iters 100000 \\
        --workspace trial_obama
    python -m mere_fusion_tpu_torch.train.ernerf_cli data/obama --iters 100000 \\
        --workspace trial_obama_torso --torso --head_ckpt trial_obama

Data dir format: transforms.json + gt_imgs/ + aud.npy + au.csv (+ parsing/,
+ torso_imgs/ for the torso stage). Runs on the current CUDA device unless
``--device cpu``. Each head iteration trains on one random frame's ray
batch and refreshes the density grid every 16 iterations; a rerun with the
same workspace resumes from its latest checkpoint. ``--torso`` trains only
the torso nets on one random frame's torso batch an iteration, with the
head's raw parameters and density grid loaded from the ``--head_ckpt``
workspace and frozen; it starts afresh each run, as the JAX CLI does. Both
stages checkpoint ``ckpt-<step>.pt`` into their workspace, which
``nerf.ckpt`` serves. LPIPS patch and lips fine-tuning, ``--test``
evaluation and the training viewer are not ported and raise.
"""
from __future__ import annotations

import argparse
import time



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
    p.add_argument("--preload", type=int, default=1, choices=(0, 1, 2),
                   help="dataset tier: 0 disk-lazy, 1 host RAM, 2 device-resident frames")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' to run "
                        "on the CPU)")
    # flags of the JAX CLI whose features are not ported: each raises
    p.add_argument("--torso", action="store_true",
                   help="torso stage: train only the torso nets against torso_imgs/, "
                        "the head loaded from --head_ckpt and frozen")
    p.add_argument("--head_ckpt", default="",
                   help="workspace of the trained head stage to load and freeze")
    p.add_argument("--test", action="store_true")
    p.add_argument("--patch_size", type=int, default=0)
    p.add_argument("--finetune_lips", action="store_true")
    p.add_argument("--viewer_port", type=int, default=None)
    args = p.parse_args(argv)
    unported = (("test", args.test, "ER-NeRF evaluation"),
                ("patch_size", args.patch_size > 0, "ER-NeRF LPIPS fine-tuning"),
                ("finetune_lips", args.finetune_lips, "ER-NeRF LPIPS fine-tuning"),
                ("viewer_port", args.viewer_port is not None, "ER-NeRF training viewer"))
    for flag, given, item in unported:
        if given:
            raise NotImplementedError(f"--{flag} is not ported to the PyTorch package yet "
                                      f"(ROADMAP: '{item}')")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

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
    dataset = NeRFTrainDataset.load(args.data_dir, preload=args.preload, device=device)
    print(f"[train] {len(dataset)} frames, {dataset.H}x{dataset.W}, on {device}")

    net_cfg = NeRFNetConfig(
        audio_in_dim=args.audio_dim, num_train_frames=len(dataset), torso=args.torso,
        num_levels=args.num_levels, base_resolution=args.base_resolution,
        desired_resolution=args.desired_resolution,
        log2_hashmap_size=args.log2_hashmap_size)
    network = init_ernerf_(NeRFNetwork(net_cfg).to(device), args.seed)
    tcfg = NeRFTrainConfig(grid_size=args.grid_size, iters=args.iters, lr=args.lr,
                           lr_net=args.lr_net)
    if args.torso:
        _train_torso(args, dataset, network, tcfg, device)
        return
    state = init_nerf_train(network, tcfg)
    step = make_nerf_train_step(tcfg)

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
            batch = dataset.sample_rays(frame, args.num_rays, rng)
            noise_gen.manual_seed(it)          # the JAX loop's jax.random.key(it)
            metrics = step(state, batch, generator=noise_gen)
            if it % 16 == 0:
                refresh_density_grid(state, mean_auds, tcfg)
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
        slog.close()
        ckpt.close()
    print("[train] done")


def _train_torso(args, dataset, network, tcfg, device) -> None:
    """The torso stage: the head workspace's raw parameters (``network``,
    not its EMA) and trained density grid, the torso trained alone, a
    checkpoint of the whole state in the workspace."""
    import numpy as np

    from mere_fusion_tpu_torch.models.ernerf.renderer import DensityGrid
    from mere_fusion_tpu_torch.train.ernerf_train import (
        init_torso_train,
        make_torso_train_step,
    )
    from mere_fusion_tpu_torch.train.logger import ScalarLogger, StopFlag
    from mere_fusion_tpu_torch.utils.checkpoint import Checkpointer

    head = None
    if args.head_ckpt:
        head = Checkpointer(args.head_ckpt).restore(map_location=device)
    state = init_torso_train(network, tcfg, head_params=head["network"] if head else None)
    if head is not None:
        # the head's trained grid rides along (a model buffer in the reference)
        state.density = DensityGrid(**head["density"])
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
