"""Avatar bundle preparation: a video of a face → a Wav2Lip or MuseTalk
avatar bundle.

Port of mere_fusion_tpu/tools/genavatar.py, the twin of the reference's
offline preparation:

- Wav2Lip (reference wav2lip/genavatar.py): video → frames → batched S3FD
  detection with a batch-halving retry on running out of memory → box
  smoothing over 5 frames → face crops and coords.pkl;
- MuseTalk (reference musetalk/mere_musetalk.py): adds the VAE latent
  pairs of each frame's face, blend masks (BiSeNet parsing with
  ``--bisenet_ckpt``, else feathered face boxes) and their crop boxes;
  ``--fan_ckpt`` refines the boxes with FAN's 68 landmarks.

The face models run on the current CUDA device (``--device cpu`` off the
card); the bundles load through ``engines/avatar.load_lip_avatar`` and
``engines/muse.load_muse_avatar``. Each stage's host time goes to a
``genavatar.*`` meter (decode, detect, landmarks, parse, crop, encode,
write).

    python -m mere_fusion_tpu_torch.tools.genavatar video.mp4 \\
        --kind wav2lip --out data/avatars/wav2lip_avatar1 --s3fd_ckpt s3fd.pth
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import time

import cv2
import numpy as np

from mere_fusion_tpu_torch.runtime.metrics import metrics


@contextlib.contextmanager
def _stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.latency(f"genavatar.{name}").observe(time.perf_counter() - t0)


def _imwrite(path: str, image: np.ndarray) -> None:
    with _stage("write"):
        cv2.imwrite(path, image)


def video_to_frames(path: str, fps: int = 25) -> list[np.ndarray]:
    """Decode a video to BGR frames (reference genavatar.py)."""
    with _stage("decode"):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
    return frames


def smooth_boxes(boxes: np.ndarray, T: int = 5) -> np.ndarray:
    """Temporal mean over a window of T (reference genavatar.py)."""
    out = boxes.copy().astype(np.float32)
    for i in range(len(boxes)):
        window = boxes[max(0, i - T + 1) : i + 1] if i + T > len(boxes) else boxes[i : i + T]
        out[i] = np.mean(window, axis=0)
    return out


def detect_face_boxes(frames: list[np.ndarray], detector, batch_size: int = 16,
                      pads=(0, 10, 0, 0)) -> list[tuple[int, int, int, int]]:
    """One face box a frame, (y1, y2, x1, x2) with padding. A batch that
    raises RuntimeError (torch.cuda.OutOfMemoryError is one) is retried at
    half the size, down to 1 (reference genavatar.py)."""
    results = []
    with _stage("detect"):
        while True:
            try:
                results = []
                for i in range(0, len(frames), batch_size):
                    chunk = np.stack(frames[i : i + batch_size])
                    results.extend(detector.detect_batch(chunk))
                break
            except RuntimeError:
                if batch_size == 1:
                    raise
                batch_size //= 2
    pady1, pady2, padx1, padx2 = pads
    boxes = []
    for frame, dets in zip(frames, results):
        if len(dets) == 0:
            raise ValueError("face not detected in a frame")
        best = dets[np.argmax(dets[:, 4])]
        x1, y1, x2, y2 = best[:4]
        h, w = frame.shape[:2]
        boxes.append(
            [
                max(0, int(y1) - pady1), min(h, int(y2) + pady2),
                max(0, int(x1) - padx1), min(w, int(x2) + padx2),
            ]
        )
    smoothed = smooth_boxes(np.asarray(boxes), T=5).astype(int)
    return [tuple(b) for b in smoothed]


def create_lip_avatar(frames: list[np.ndarray], out_dir: str, detector,
                      img_size: int = 96, pads=(0, 10, 0, 0)) -> str:
    """Write a Wav2Lip avatar bundle (full_imgs/, face_imgs/, coords.pkl)."""
    boxes = detect_face_boxes(frames, detector, pads=pads)
    full_dir = os.path.join(out_dir, "full_imgs")
    face_dir = os.path.join(out_dir, "face_imgs")
    os.makedirs(full_dir, exist_ok=True)
    os.makedirs(face_dir, exist_ok=True)
    for i, (frame, (y1, y2, x1, x2)) in enumerate(zip(frames, boxes)):
        _imwrite(os.path.join(full_dir, f"{i}.png"), frame)
        with _stage("crop"):
            crop = cv2.resize(frame[y1:y2, x1:x2], (img_size, img_size))
        _imwrite(os.path.join(face_dir, f"{i}.png"), crop)
    with _stage("write"), open(os.path.join(out_dir, "coords.pkl"), "wb") as f:
        pickle.dump(boxes, f)
    return out_dir


def feathered_mask(frame_hw: tuple[int, int], face_box, pad: int = 16,
                   blur: int = 31):
    """Blend mask and crop box around a face box (stand-in for BiSeNet)."""
    h, w = frame_hw
    x1, y1, x2, y2 = face_box
    xs, ys = max(0, x1 - pad), max(0, y1 - pad)
    xe, ye = min(w, x2 + pad), min(h, y2 + pad)
    mask = np.zeros((ye - ys, xe - xs), np.uint8)
    mask[y1 - ys : y2 - ys, x1 - xs : x2 - xs] = 255
    k = blur | 1
    mask = cv2.GaussianBlur(mask, (k, k), 0)
    return cv2.cvtColor(mask, cv2.COLOR_GRAY2BGR), (xs, ys, xe, ye)


def get_landmark_and_bbox(frames: list[np.ndarray], detector,
                          landmark_detector=None,
                          upperbondrange: int = 0) -> list[tuple]:
    """Landmark-refined face boxes, the reference's dwpose + S3FD fusion
    (musetalk/utils/preprocessing.py) with FAN's 68 points standing in for
    the wholebody face keypoints (the same 68-point convention):

      half_face = landmark 29 (+ the optional bbox_shift on y)
      upper_bond = half_face.y - (max(y) - half_face.y)
      box = (min(x), upper_bond, max(x), max(y)); a degenerate box falls
      back to the S3FD detection.

    Returns (x1, y1, x2, y2) per frame.
    """
    raw = detect_face_boxes(frames, detector, pads=(0, 0, 0, 0))
    if landmark_detector is None:
        return [(x1, y1, x2, y2) for (y1, y2, x1, x2) in raw]
    coords = []
    ranges_minus, ranges_plus = [], []
    for frame, (y1, y2, x1, x2) in zip(frames, raw):
        # landmarks from the detected box (no second S3FD pass)
        with _stage("landmarks"):
            lms = landmark_detector.landmarks_from_boxes(
                frame[:, :, ::-1], [np.array([x1, y1, x2, y2], np.float32)]
            )
        if not lms:
            coords.append((x1, y1, x2, y2))
            continue
        lm = lms[0].astype(np.int32)
        half_face = lm[29].copy()
        ranges_minus.append(int(lm[30, 1] - lm[29, 1]))
        ranges_plus.append(int(lm[29, 1] - lm[28, 1]))
        if upperbondrange != 0:
            half_face[1] += upperbondrange
        half_face_dist = int(lm[:, 1].max()) - int(half_face[1])
        upper_bond = int(half_face[1]) - half_face_dist
        box = (int(lm[:, 0].min()), upper_bond,
               int(lm[:, 0].max()), int(lm[:, 1].max()))
        if box[3] - box[1] <= 0 or box[2] - box[0] <= 0 or box[0] < 0:
            coords.append((x1, y1, x2, y2))  # the detector's box
        else:
            coords.append(box)
    if ranges_minus:
        print(f"[muse-prep] bbox_shift adjust range: "
              f"[-{int(np.mean(ranges_minus))}~{int(np.mean(ranges_plus))}], "
              f"current {upperbondrange}")
    return coords


def create_muse_avatar(frames: list[np.ndarray], out_dir: str, detector,
                       models, bbox_shift: int = 0, face_parser=None,
                       landmark_detector=None, encode_batch: int | None = 16) -> str:
    """Write a MuseTalk avatar bundle (full_imgs/, coords.pkl, latents.npy,
    mask/, mask_coords.pkl, avator_info.json).

    face_parser: a models.bisenet.FaceParsing, whose parsing makes the blend
    masks as the reference's does; without one, feathered boxes.
    landmark_detector: a models.fan.LandmarkDetector or a models.rtmpose
    WholebodyLandmarker (the reference's DWPose) for the reference's
    landmark-refined boxes. The faces are VAE-encoded ``encode_batch`` at a
    time (all in one call when None): a minute of video is 1,500 faces,
    whose first 128-channel activations alone take ~50 GB in one call."""
    import torch

    from mere_fusion_tpu_torch.engines.muse import preprocess_face

    loop_shift = bbox_shift  # what the crop loop still needs to apply
    if landmark_detector is not None:
        fused = get_landmark_and_bbox(frames, detector, landmark_detector,
                                      upperbondrange=bbox_shift)
        # the loop takes (y1, y2, x1, x2); the shift is already in the
        # landmark boxes (bbox_shift stays as it is for avator_info.json)
        raw = [(y1, y2, x1, x2) for (x1, y1, x2, y2) in fused]
        loop_shift = 0
    else:
        raw = detect_face_boxes(frames, detector, pads=(0, 0, 0, 0))
    full_dir = os.path.join(out_dir, "full_imgs")
    mask_dir = os.path.join(out_dir, "mask")
    os.makedirs(full_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    coords, faces, mask_coords = [], [], []
    for i, (frame, (y1, y2, x1, x2)) in enumerate(zip(frames, raw)):
        y1 = max(0, y1 + loop_shift)
        box = (x1, y1, x2, y2)  # MuseTalk's coordinate order
        coords.append(box)
        _imwrite(os.path.join(full_dir, f"{i}.png"), frame)
        with _stage("crop"):
            faces.append(
                preprocess_face(frame[y1:y2, x1:x2], models.face_size, half_mask=False))
        if face_parser is not None:
            pad = 16
            h, w = frame.shape[:2]
            xs, ys = max(0, x1 - pad), max(0, y1 - pad)
            xe, ye = min(w, x2 + pad), min(h, y2 + pad)
            crop = frame[ys:ye, xs:xe]
            with _stage("parse"):
                parsed = face_parser(crop, size=(crop.shape[1], crop.shape[0]))
            parsed = cv2.GaussianBlur(parsed, (15, 15), 0)
            mask = cv2.cvtColor(parsed, cv2.COLOR_GRAY2BGR)
            crop_box = (xs, ys, xe, ye)
        else:
            mask, crop_box = feathered_mask(frame.shape[:2], box)
        _imwrite(os.path.join(mask_dir, f"{i}.png"), mask)
        mask_coords.append(crop_box)

    step = encode_batch or len(faces)
    with _stage("encode"):
        latents = np.concatenate([
            models.encode_pair(torch.from_numpy(np.stack(faces[i:i + step]))).cpu().numpy()
            for i in range(0, len(faces), step)])
    with _stage("write"):
        np.save(os.path.join(out_dir, "latents.npy"), latents)
        with open(os.path.join(out_dir, "coords.pkl"), "wb") as f:
            pickle.dump(coords, f)
        with open(os.path.join(out_dir, "mask_coords.pkl"), "wb") as f:
            pickle.dump(mask_coords, f)
        with open(os.path.join(out_dir, "avator_info.json"), "w") as f:
            json.dump({"avatar_id": os.path.basename(out_dir),
                       "bbox_shift": bbox_shift}, f)
    return out_dir


class FixedBoxDetector:
    """Deterministic detector for tests and footage of a known layout."""

    def __init__(self, box_xyxy: tuple[float, float, float, float], score: float = 0.99):
        self.box = box_xyxy
        self.score = score

    def detect_batch(self, imgs: np.ndarray, **kw):
        det = np.asarray([[*self.box, self.score]], np.float32)
        return [det.copy() for _ in range(len(imgs))]


def main(argv=None) -> None:
    """The avatar preparation CLI (the reference's genavatar.py and
    mere_musetalk.py entry points)."""
    import argparse

    p = argparse.ArgumentParser("genavatar")
    p.add_argument("video")
    p.add_argument("--kind", default="wav2lip",
                   choices=["wav2lip", "musetalk"])
    p.add_argument("--out", required=True)
    p.add_argument("--img_size", type=int, default=96)
    p.add_argument("--bbox_shift", type=int, default=0)
    p.add_argument("--s3fd_ckpt", default=None,
                   help="reference S3FD .pth (seeded random weights without "
                        "it: only useful for smoke runs)")
    p.add_argument("--fan_ckpt", default=None,
                   help="2DFAN4 .pth for landmark-refined musetalk boxes")
    p.add_argument("--dwpose_ckpt", default=None,
                   help="RTMPose wholebody dw-ll_ucoco_384.pth, the reference's "
                        "own musetalk landmarker")
    p.add_argument("--bisenet_ckpt", default=None,
                   help="79999_iter.pth for parsing-based blend masks")
    p.add_argument("--vae_ckpt", default=None,
                   help="musetalk sd-vae weights (diffusers .bin/.pth; seeded "
                        "random VAE without it)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    from mere_fusion_tpu_torch.device import resolve_device
    from mere_fusion_tpu_torch.models.s3fd import FaceDetector

    device = resolve_device(args.device)
    detector = (FaceDetector.from_checkpoint(args.s3fd_ckpt, device=device)
                if args.s3fd_ckpt else FaceDetector(device=device))
    frames = video_to_frames(args.video)
    print(f"[genavatar] {len(frames)} frames")

    if args.kind == "wav2lip":
        create_lip_avatar(frames, args.out, detector, img_size=args.img_size)
    else:
        from mere_fusion_tpu_torch.engines.muse import MuseModels

        vae_state = None
        if args.vae_ckpt:
            from mere_fusion_tpu_torch.engines import load_serving_tree

            vae_state, _ = load_serving_tree("vae", args.vae_ckpt)
        models = MuseModels(vae_state=vae_state, device=device)
        landmark_detector = None
        if args.dwpose_ckpt:
            from mere_fusion_tpu_torch.models.rtmpose import WholebodyLandmarker

            landmark_detector = WholebodyLandmarker.from_checkpoint(args.dwpose_ckpt,
                                                                    device=device)
        elif args.fan_ckpt:
            from mere_fusion_tpu_torch.models.fan import LandmarkDetector

            landmark_detector = LandmarkDetector.from_checkpoints(
                args.fan_ckpt, args.s3fd_ckpt, device=device)
        face_parser = None
        if args.bisenet_ckpt:
            from mere_fusion_tpu_torch.models.bisenet import FaceParsing

            face_parser = FaceParsing.from_checkpoint(args.bisenet_ckpt, device=device)
        create_muse_avatar(frames, args.out, detector, models,
                           bbox_shift=args.bbox_shift,
                           face_parser=face_parser,
                           landmark_detector=landmark_detector)
    print(f"[genavatar] wrote {args.out}")


if __name__ == "__main__":
    main()
