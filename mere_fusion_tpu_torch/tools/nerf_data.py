"""ER-NeRF training-data preparation pipeline.

Port of mere_fusion_tpu/tools/nerf_data.py, the twin of the reference's
9-task video → training-data pipeline (reference
ernerf/data_utils/process.py:368-400). Each task runs on the port's own
models; a task whose model or tool is missing raises an error that names
it:

1. extract_audio        ffmpeg → 16 kHz wav
2. audio_features       wav2vec2 CTC logits (transformers; a local model
                        directory), DeepSpeech 29-dim logits
                        (audio/deepspeech.py, the frozen .pb), or any
                        logits_fn
3. extract_frames       25 fps frames
4. face_parsing         models/bisenet.py (79999_iter.pth)
5. extract_background   median of background-labeled pixels across frames
6. composites           gt_imgs (head+bg) and torso_imgs from parsing
7. landmarks            models/fan.py 2DFAN-4 with models/s3fd.py boxes →
                        per-frame .lms files
8. face_tracking        3DMM landmark fitting (tools/face_tracking.py) and,
                        with --photometric, the photometric refinement
                        (tools/render_3dmm.py)
9. export_transforms    transforms.json from tracked poses

    python -m mere_fusion_tpu_torch.tools.nerf_data <video-or-dir> --task N

The models run on the current CUDA device, or where --device says.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess

import cv2
import numpy as np


def extract_audio(video_path: str, out_wav: str, sample_rate: int = 16000) -> str:
    if shutil.which("ffmpeg") is None:
        raise FileNotFoundError("task 1 (extract_audio) runs the 'ffmpeg' binary, and no "
                                "ffmpeg is on the PATH")
    subprocess.run(
        ["ffmpeg", "-y", "-loglevel", "error", "-i", video_path,
         "-f", "wav", "-ar", str(sample_rate), "-ac", "1", out_wav],
        check=True,
    )
    return out_wav


def extract_frames(video_path: str, out_dir: str, fps: int = 25) -> int:
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        cv2.imwrite(os.path.join(out_dir, f"{i}.jpg"), frame)
        i += 1
    cap.release()
    return i


def audio_features(wav_path: str, out_npy: str, logits_fn=None,
                   model_name: str = "cpierse/wav2vec2-large-xlsr-53-esperanto",
                   window: int = 16, device=None) -> str:
    """Per-frame CTC logits windows [N, window, A] (process.py task 2 and
    the reference ASR's --asr_save_feats layout)."""
    from scipy.io import wavfile

    from mere_fusion_tpu_torch.tts import resample_pcm

    sr, pcm = wavfile.read(wav_path)
    if pcm.dtype == np.int16:
        pcm = pcm.astype(np.float32) / 32768.0
    if pcm.ndim > 1:
        pcm = pcm[:, 0]
    pcm = resample_pcm(pcm.astype(np.float32), sr, 16000)

    if logits_fn is None:
        from mere_fusion_tpu_torch.engines.nerf import wav2vec_logits_fn

        logits_fn = wav2vec_logits_fn(model_name, device=device)
    logits = logits_fn(pcm)                       # [T50, A] at 50 Hz
    n_frames = len(logits) // 2                   # 25 fps video frames
    half = window // 2
    idx = np.clip(
        np.arange(n_frames)[:, None] * 2 + np.arange(-half, half)[None, :],
        0, len(logits) - 1,
    )
    feats = logits[idx]                           # [N, 16, A]
    np.save(out_npy, feats.astype(np.float32))
    return out_npy


def face_parsing(frames_dir: str, out_dir: str, parser) -> int:
    """Per-frame BiSeNet semantics (process.py task 4): color-coded
    head/neck/torso/background maps (the format tasks 5/6 consume).

    parser: models/bisenet.FaceParsing (its semantic_map; a plain face-mask
    callable falls back to head-only maps)."""
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(os.listdir(frames_dir), key=lambda x: int(x.split(".")[0]))
    for name in names:
        img = cv2.imread(os.path.join(frames_dir, name))
        if hasattr(parser, "semantic_map"):
            out = parser.semantic_map(img)
        else:
            mask = parser(img, size=(512, 512))
            mask = cv2.resize(mask, (img.shape[1], img.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
            out = np.full((*mask.shape, 3), 255, np.uint8)
            out[mask > 0] = (255, 0, 0)  # head in blue (reference colors)
        cv2.imwrite(os.path.join(out_dir, name.split(".")[0] + ".png"), out)
    return len(names)


def _inpaint_down_from(top_coords: np.ndarray, colors: np.ndarray,
                       length: int, image: np.ndarray):
    """Paint `length` rows upward from each top pixel with its color darkened
    by 0.98 per row (the reference's vertical inpainting,
    process.py:152-220). Returns the painted coords mask."""
    h = image.shape[0]
    coords = top_coords[None].repeat(length, 0)  # [L, m, 2]
    offsets = np.stack([-np.arange(length),
                        np.zeros(length, dtype=np.int64)], -1)[:, None]
    coords = (coords + offsets).reshape(-1, 2)
    cols = colors[None].repeat(length, 0)
    darken = 0.98 ** np.arange(length).reshape(length, 1, 1)
    cols = (cols * darken).reshape(-1, 3)
    keep = (coords[:, 0] >= 0) & (coords[:, 0] < h)
    coords, cols = coords[keep], cols[keep]
    image[tuple(coords.T)] = cols
    mask = np.zeros(image.shape[:2], bool)
    mask[tuple(coords.T)] = True
    return mask


def _top_of_columns(part: np.ndarray):
    """Top-most pixel of each column of a boolean region; returns coords
    [m, 2] and per-column counts."""
    coords = np.stack(np.nonzero(part), axis=-1)
    if len(coords) == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.int64)
    coords = coords[np.lexsort((coords[:, 0], coords[:, 1]))]
    _, uid, ucnt = np.unique(coords[:, 1], return_index=True,
                             return_counts=True)
    return coords[uid], ucnt


def extract_torso_and_gt(base_dir: str, ori_imgs_dir: str) -> int:
    """gt_imgs (head over clean background) + torso_imgs (RGBA torso with
    the reference's vertical inpainting under the chin), process.py task 6
    (extract_torso_and_gt, process.py:120-240).

    Needs bc.jpg (task 5) and parsing/ semantic maps (task 4)."""
    import glob

    from scipy.ndimage import binary_dilation

    bg_image = cv2.imread(os.path.join(base_dir, "bc.jpg"), cv2.IMREAD_UNCHANGED)
    gt_dir = os.path.join(base_dir, "gt_imgs")
    torso_dir = os.path.join(base_dir, "torso_imgs")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(torso_dir, exist_ok=True)

    image_paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
    for image_path in image_paths:
        ori = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
        stem = os.path.splitext(os.path.basename(image_path))[0]
        seg = cv2.imread(os.path.join(base_dir, "parsing", f"{stem}.png"))
        head = (seg[..., 0] == 255) & (seg[..., 1] == 0) & (seg[..., 2] == 0)
        neck = (seg[..., 0] == 0) & (seg[..., 1] == 255) & (seg[..., 2] == 0)
        torso = (seg[..., 0] == 0) & (seg[..., 1] == 0) & (seg[..., 2] == 255)
        bg = (seg[..., 0] == 255) & (seg[..., 1] == 255) & (seg[..., 2] == 255)

        gt = ori.copy()
        gt[bg] = bg_image[bg]
        cv2.imwrite(os.path.join(gt_dir, f"{stem}.jpg"), gt)

        torso_img = gt.copy()
        torso_img[head] = bg_image[head]
        alpha = np.full((*gt.shape[:2], 1), 255, np.uint8)

        # torso top rows whose upper neighbor is head → paint 9 rows up
        top, _ = _top_of_columns(torso)
        inpaint_torso_mask = None
        if len(top):
            up = top - np.array([1, 0])
            keep = head[tuple(up.T)]
            if keep.any():
                top = top[keep]
                inpaint_torso_mask = _inpaint_down_from(
                    top, gt[tuple(top.T)], 8 + 1, torso_img)

        # dilated-neck top rows, pushed down 4 px, painted 53 rows up
        push_down = 4
        neck_d = binary_dilation(
            neck, structure=np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], bool),
            iterations=3)
        top, ucnt = _top_of_columns(neck_d)
        inpaint_mask = np.zeros(gt.shape[:2], bool)
        if len(top):
            up = top - np.array([1, 0])
            keep = head[tuple(up.T)]
            top, ucnt = top[keep], ucnt[keep]
            if len(top):
                down = np.minimum(ucnt - 1, push_down)
                top = top + np.stack([down, np.zeros_like(down)], -1)
                inpaint_mask = _inpaint_down_from(
                    top, gt[tuple(top.T)], 48 + push_down + 1, torso_img)
                # blur the painted strip to soften vertical-line artifacts
                blur = cv2.GaussianBlur(torso_img, (5, 5), cv2.BORDER_DEFAULT)
                torso_img[inpaint_mask] = blur[inpaint_mask]

        mask = neck_d | torso | inpaint_mask
        if inpaint_torso_mask is not None:
            mask = mask | inpaint_torso_mask
        torso_img[~mask] = 0
        alpha[~mask] = 0
        cv2.imwrite(os.path.join(torso_dir, f"{stem}.png"),
                    np.concatenate([torso_img, alpha], axis=-1))
    return len(image_paths)


def extract_background(frames_dir: str, parsing_dir: str, out_path: str,
                       sample_every: int = 10) -> str:
    """Median of non-face pixels across sampled frames (task 5)."""
    names = sorted(os.listdir(frames_dir), key=lambda x: int(x.split(".")[0]))
    stack = []
    for name in names[::sample_every]:
        img = cv2.imread(os.path.join(frames_dir, name)).astype(np.float32)
        ppath = os.path.join(parsing_dir, name.split(".")[0] + ".png")
        if os.path.exists(ppath):
            seg = cv2.imread(ppath)
            # semantic maps label background white; everything else is person
            person = ~((seg == 255).all(-1))
            img[person] = np.nan
        stack.append(img)
    bg = np.nanmedian(np.stack(stack), axis=0)
    bg = np.nan_to_num(bg, nan=255.0)
    cv2.imwrite(out_path, bg.astype(np.uint8))
    return out_path


def export_transforms(poses: np.ndarray, focal_len: float, cx: float, cy: float,
                      out_path: str, aud_ids=None) -> str:
    """transforms.json from per-frame camera poses (task 9)."""
    frames = []
    for i, pose in enumerate(poses):
        frames.append(
            {
                "img_id": i,
                "aud_id": int(aud_ids[i]) if aud_ids is not None else i,
                "transform_matrix": np.asarray(pose, np.float64).tolist(),
            }
        )
    with open(out_path, "w") as f:
        json.dump(
            {"focal_len": focal_len, "cx": cx, "cy": cy, "frames": frames}, f
        )
    return out_path


def face_tracking(landmarks_2d, image_hw, model_path: str | None = None,
                  model=None, frames=None, photometric_iters: int = 400,
                  vertex_stride: int = 8, focal_sweep: bool = False,
                  lmk_vertex_idx=None, device=None, **fit_kw):
    """3DMM head-pose tracking from 2D landmarks (process.py task 8).

    Batched landmark fitting (tools/face_tracking.py), with the reference's
    coarse focal sweep first when ``focal_sweep`` (face_tracker.py:45-126),
    then, when ``frames`` ([F, H, W, 3] float RGB in [0, 1]) are given, the
    photometric pose refinement (tools/render_3dmm.py, the reference's
    pytorch3d stage) with a jointly learned per-vertex albedo. A model with
    triangle topology refines through the soft mesh rasterizer with the
    landmark anchor (given ``lmk_vertex_idx``, the vertex id of each
    landmark column); otherwise the point-splat fallback. Returns (c2w
    poses [F,4,4], focal, fit dict).

    landmarks_2d: [F, N, 2] pixels; model_path: the reference's converted
    BFM directory (3DMM_info.npy), or pass a MorphableModel. A model loaded
    with keys_info.npy's landmark ids fits those vertices when
    ``lmk_vertex_idx`` is not given. vertex_stride subsamples vertices for
    the splat path's photometric stage."""
    from mere_fusion_tpu_torch.tools.face_tracking import (
        MorphableModel,
        fit_landmarks,
        fit_landmarks_focal_sweep,
        poses_from_fit,
    )

    if model is None:
        if model_path is None:
            raise ValueError(
                "face_tracking needs the converted BFM assets (model_path "
                "→ 3DMM_info.npy, see reference convert_BFM.py) or an "
                "explicit MorphableModel"
            )
        model = MorphableModel.load(model_path)
    if lmk_vertex_idx is None:
        lmk_vertex_idx = getattr(model, "keyinds", None)
    # the landmark stage fits the landmark vertices' sub-basis, the
    # reference's lands_info subset
    lmk_model = model if lmk_vertex_idx is None else model.subset(lmk_vertex_idx)
    fitter = fit_landmarks_focal_sweep if focal_sweep else fit_landmarks
    fit = fitter(lmk_model, landmarks_2d, image_hw, device=device, **fit_kw)
    if frames is not None:
        from mere_fusion_tpu_torch.tools.render_3dmm import refine_photometric

        use_mesh = getattr(model, "faces", None) is not None
        anchor = {}
        if use_mesh and lmk_vertex_idx is not None:
            anchor = dict(landmarks=landmarks_2d, lmk_vertex_idx=lmk_vertex_idx)
        fit = refine_photometric(model, fit, np.asarray(frames),
                                 iters=photometric_iters,
                                 vertex_stride=1 if use_mesh else vertex_stride,
                                 device=device, **anchor)
    return poses_from_fit(fit), fit["focal"], fit


def landmarks(ori_imgs_dir: str, detector=None, fan_path: str | None = None,
              s3fd_path: str | None = None, device=None):
    """68-point face landmarks per frame (process.py task 7,
    extract_landmarks at process.py:46-60): for every ``*.jpg`` in
    ``ori_imgs_dir`` write a ``.lms`` text file with the [68, 2] landmark
    array of the first detected face.

    Pass ``detector`` (a models/fan.LandmarkDetector) or the ``fan_path``
    2DFAN4 and optional ``s3fd_path`` checkpoints."""
    import glob

    from mere_fusion_tpu_torch.models.fan import LandmarkDetector

    if detector is None:
        if fan_path is None:
            raise ValueError(
                "landmarks needs a LandmarkDetector or a FAN checkpoint "
                "(fan_path=2DFAN4 .pth, optional s3fd_path)"
            )
        detector = LandmarkDetector.from_checkpoints(fan_path, s3fd_path, device=device)

    written = []
    for image_path in sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg"))):
        img = cv2.cvtColor(cv2.imread(image_path, cv2.IMREAD_UNCHANGED),
                           cv2.COLOR_BGR2RGB)
        preds = detector.get_landmarks(img)
        if preds:
            lms_path = os.path.splitext(image_path)[0] + ".lms"
            np.savetxt(lms_path, preds[0].reshape(-1, 2)[:, :2], "%f")
            written.append(lms_path)
    return written


def main(argv=None) -> None:
    """The task runner (reference process.py:368-400): ``python -m
    mere_fusion_tpu_torch.tools.nerf_data <video-or-datadir> --task N``
    (0 = all feasible tasks in order)."""
    import argparse

    p = argparse.ArgumentParser("nerf-data")
    p.add_argument("path", help="input video (tasks 1,3) or data dir")
    p.add_argument("--task", type=int, default=0, choices=range(0, 10))
    p.add_argument("--bisenet_ckpt", default=None,
                   help="torch 79999_iter.pth for tasks 4-6")
    p.add_argument("--fan_ckpt", default=None,
                   help="torch 2DFAN4 .pth for task 7")
    p.add_argument("--s3fd_ckpt", default=None)
    p.add_argument("--photometric", action="store_true",
                   help="refine task-8 poses photometrically against the "
                        "frames (reference render_3dmm stage)")
    p.add_argument("--bfm_dir", default=None,
                   help="converted BFM assets (3DMM_info.npy) for tasks 8-9")
    p.add_argument("--asr_model",
                   default="cpierse/wav2vec2-large-xlsr-53-esperanto")
    p.add_argument("--deepspeech_pb", default=None,
                   help="use DeepSpeech features (frozen .pb) for task 2")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    if os.path.isfile(args.path):
        base = os.path.splitext(args.path)[0]
        os.makedirs(base, exist_ok=True)
        video = args.path
    else:
        base = args.path
        video = None
    ori = os.path.join(base, "ori_imgs")
    wav = os.path.join(base, "aud.wav")

    def want(n):
        return args.task in (0, n)

    if want(1) and video:
        print("[task 1] extract_audio")
        extract_audio(video, wav)
    if want(2) and os.path.exists(wav):
        print("[task 2] audio_features")
        logits_fn = None
        if args.deepspeech_pb:
            from mere_fusion_tpu_torch.audio.deepspeech import deepspeech_logits_fn

            logits_fn = deepspeech_logits_fn(args.deepspeech_pb, device=args.device)
        audio_features(wav, os.path.join(base, "aud.npy"),
                       logits_fn=logits_fn, model_name=args.asr_model, device=args.device)
    if want(3) and video:
        print("[task 3] extract_frames")
        extract_frames(video, ori)
    if want(4):
        if args.bisenet_ckpt:
            print("[task 4] face_parsing")
            from mere_fusion_tpu_torch.models.bisenet import FaceParsing

            parser = FaceParsing.from_checkpoint(args.bisenet_ckpt, device=args.device)
            face_parsing(ori, os.path.join(base, "parsing"), parser)
        elif args.task == 4:
            raise SystemExit("task 4 needs --bisenet_ckpt")
    if want(5):
        if os.path.isdir(os.path.join(base, "parsing")):
            print("[task 5] extract_background")
            extract_background(ori, os.path.join(base, "parsing"),
                               os.path.join(base, "bc.jpg"))
        elif args.task == 5:
            raise SystemExit("task 5 needs parsing/ (run task 4 first)")
    if want(6):
        if os.path.exists(os.path.join(base, "bc.jpg")):
            print("[task 6] extract_torso_and_gt")
            extract_torso_and_gt(base, ori)
        elif args.task == 6:
            raise SystemExit("task 6 needs bc.jpg (run task 5 first)")
    if want(7):
        if args.fan_ckpt:
            print("[task 7] landmarks")
            landmarks(ori, fan_path=args.fan_ckpt, s3fd_path=args.s3fd_ckpt,
                      device=args.device)
        elif args.task == 7:
            raise SystemExit("task 7 needs --fan_ckpt")
    if want(8) or want(9):
        if args.bfm_dir:
            import glob as _glob

            print("[task 8] face_tracking")
            lms_paths = sorted(
                _glob.glob(os.path.join(ori, "*.lms")),
                key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
            )
            if not lms_paths:
                raise SystemExit(
                    "tasks 8-9 need .lms landmark files in ori_imgs/ — "
                    "run task 7 (requires --fan_ckpt) first"
                )
            lms = np.stack([np.loadtxt(p) for p in lms_paths])
            sample = cv2.imread(os.path.join(
                ori, os.path.basename(lms_paths[0]).replace(".lms", ".jpg")))
            if args.photometric:
                # photometric refinement at quarter resolution: pose
                # gradients don't need full-res pixels
                frames = np.stack([
                    cv2.cvtColor(
                        cv2.imread(str(pp).replace(".lms", ".jpg")),
                        cv2.COLOR_BGR2RGB,
                    ).astype(np.float32) / 255.0
                    for pp in lms_paths
                ])[:, ::4, ::4]
                lms_scaled = lms.astype(np.float32) / 4.0
                poses, focal, _fit = face_tracking(
                    lms_scaled, frames.shape[1:3],
                    model_path=args.bfm_dir, frames=frames, device=args.device,
                )
                focal *= 4.0  # back to full-res intrinsics
            else:
                poses, focal, _fit = face_tracking(
                    lms.astype(np.float32), sample.shape[:2],
                    model_path=args.bfm_dir, device=args.device,
                )
            print("[task 9] export_transforms")
            h, w = sample.shape[:2]
            export_transforms(poses, float(focal), w / 2, h / 2,
                              os.path.join(base, "transforms.json"))
        elif args.task in (8, 9):
            raise SystemExit("tasks 8-9 need --bfm_dir")
    print("[nerf-data] done")


if __name__ == "__main__":
    main()
