"""ER-NeRF datasets: the test set (poses, blink areas, background) and the
training set (frames, face masks, audio windows, random-pixel ray batches).

Port of mere_fusion_tpu/data/provider.py (the twin of the reference's
NeRFDataset and NeRFDataset_Test): transforms.json poses converted to NGP
coordinates, optional camera-path smoothing, AU45 blink areas from
OpenFace's au.csv (read with ``csv``: no pandas), infinite mirrored looping
for live streaming, the training set's preload tiers 0/1/2 and its torso
images and batches (``torso_imgs/``), and the procedural datasets the tests
and ``chip_smoke.py`` train on (without torso images or landmarks: the
callers write them). Besides random pixels, a training batch can be square
patches (the LPIPS patch loss) or the static window over the lips that the
lips fine-tuning trains on, its rect read from the frames' ``.lms``
landmark files.
"""
from __future__ import annotations

import csv
import json
import os
from collections import OrderedDict
from dataclasses import dataclass

import cv2
import numpy as np
import torch

from mere_fusion_tpu_torch.device import resolve_device


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float, offset=(0, 0, 0)) -> np.ndarray:
    """Axis permutation + scaling into the NGP convention."""
    return np.array(
        [
            [pose[1, 0], -pose[1, 1], -pose[1, 2], pose[1, 3] * scale + offset[0]],
            [pose[2, 0], -pose[2, 1], -pose[2, 2], pose[2, 3] * scale + offset[1]],
            [pose[0, 0], -pose[0, 1], -pose[0, 2], pose[0, 3] * scale + offset[2]],
            [0, 0, 0, 1],
        ],
        dtype=np.float32,
    )


def ngp_to_nerf_matrix(pose: np.ndarray, scale: float, offset=(0, 0, 0)) -> np.ndarray:
    """Exact inverse of nerf_matrix_to_ngp (for synthesizing datasets)."""
    out = np.eye(4, dtype=np.float32)
    out[0, :3] = pose[2, :3] * np.array([1, -1, -1])
    out[1, :3] = pose[0, :3] * np.array([1, -1, -1])
    out[2, :3] = pose[1, :3] * np.array([1, -1, -1])
    out[0, 3] = (pose[2, 3] - offset[2]) / scale
    out[1, 3] = (pose[0, 3] - offset[0]) / scale
    out[2, 3] = (pose[1, 3] - offset[1]) / scale
    return out


def smooth_camera_path(poses: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    n = poses.shape[0]
    k = kernel_size // 2
    trans = poses[:, :3, 3].copy()
    rots = poses[:, :3, :3].copy()
    for i in range(n):
        lo, hi = max(0, i - k), min(n, i + k + 1)
        poses[i, :3, 3] = trans[lo:hi].mean(0)
        poses[i, :3, :3] = Rotation.from_matrix(rots[lo:hi]).mean().as_matrix()
    return poses


def read_au45(au_path: str) -> np.ndarray:
    """The AU45_r (blink) column of an OpenFace au.csv, whose header names
    carry a leading space."""
    with open(au_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return np.asarray([float(r[" AU45_r"]) for r in rows], np.float64)


@dataclass
class NeRFTestDataset:
    poses: np.ndarray        # [N, 4, 4] NGP-space c2w
    eye_area: np.ndarray     # [N] in [0, 1] (AU45/2 clipped)
    bg_img: np.ndarray       # [H, W, 3] float32 RGB
    intrinsics: tuple        # (fx, fy, cx, cy)
    H: int
    W: int

    def __len__(self) -> int:
        return self.poses.shape[0]

    def mirror_index(self, index: int) -> int:
        size = len(self)
        turn, res = divmod(index, size)
        return res if turn % 2 == 0 else size - res - 1

    def collate(self, index: int) -> dict:
        i = self.mirror_index(index)
        return {
            "index": i,
            "pose": self.poses[i],
            "eye": np.asarray([[self.eye_area[i]]], np.float32),
            "bg_color": self.bg_img.reshape(-1, 3),
        }

    def __iter__(self):
        i = 0
        while True:
            yield self.collate(i)
            i += 1

    @classmethod
    def load(cls, pose_path: str, au_path: str = "", bg_img: str = "white",
             scale: float = 4.0, offset=(0, 0, 0), smooth_path: bool = False,
             smooth_path_window: int = 7, smooth_eye: bool = False,
             data_range=(0, -1)) -> "NeRFTestDataset":
        with open(pose_path) as f:
            transform = json.load(f)
        H = int(transform["cy"]) * 2
        W = int(transform["cx"]) * 2
        frames = transform["frames"]
        end = data_range[1] if data_range[1] != -1 else len(frames)
        frames = frames[data_range[0]: end]

        au_blink = read_au45(au_path) if au_path else None
        poses, eye_area = [], []
        for fr in frames:
            poses.append(nerf_matrix_to_ngp(
                np.array(fr["transform_matrix"], np.float32), scale, offset))
            if au_blink is not None:
                area = float(np.clip(au_blink[fr["img_id"]], 0, 2)) / 2
            else:
                area = 0.25  # default open eye
            eye_area.append(area)
        poses = np.stack(poses)
        if smooth_path:
            poses = smooth_camera_path(poses, smooth_path_window)
        eye_area = np.asarray(eye_area, np.float32)
        if smooth_eye:
            smoothed = eye_area.copy()
            for i in range(len(eye_area)):
                lo, hi = max(0, i - 1), min(len(eye_area), i + 2)
                smoothed[i] = eye_area[lo:hi].mean()
            eye_area = smoothed

        if bg_img == "white":
            bg = np.ones((H, W, 3), np.float32)
        elif bg_img == "black":
            bg = np.zeros((H, W, 3), np.float32)
        else:
            img = cv2.imread(bg_img, cv2.IMREAD_UNCHANGED)
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            bg = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255

        fl = transform["focal_len"]
        intrinsics = (fl, fl, transform["cx"], transform["cy"])
        return cls(poses, eye_area, bg, intrinsics, H, W)


class LazyFrames:
    """preload=0 image store: decode ground-truth frames from disk on access
    with a small LRU. Supports the eager array's consumer surface: len,
    [i] → float32 [H, W, 3], .shape."""

    def __init__(self, paths: list, cache: int = 16):
        self._paths = paths
        self._lru: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cap = cache
        first = self._decode(0)
        self.shape = (len(paths),) + first.shape

    @staticmethod
    def _imread(path: str) -> np.ndarray:
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)

    def _decode(self, i: int) -> np.ndarray:
        img = self._imread(self._paths[i]).astype(np.float32) / 255
        self._lru[i] = img
        if len(self._lru) > self._cap:
            self._lru.popitem(last=False)
        return img

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, i: int) -> np.ndarray:
        hit = self._lru.get(i)
        if hit is not None:
            self._lru.move_to_end(i)
            return hit
        return self._decode(i)


@dataclass
class NeRFTrainDataset:
    """Training-time dataset: poses, ground-truth frames, per-frame audio
    feature windows, blink areas and face masks, with random-pixel ray
    batches on ``device``.

    Preload tiers: 0 keeps frames on disk (LazyFrames), 1 decodes them into
    host RAM, 2 also holds the uint8 frames, the masks and the background on
    the device, where the batch gathers then run."""

    poses: np.ndarray        # [N, 4, 4]
    images: np.ndarray       # [N, H, W, 3] float32 RGB in [0, 1] (or LazyFrames)
    auds: np.ndarray         # [N, A, 16] audio windows
    eye_area: np.ndarray     # [N]
    face_masks: np.ndarray   # [N, H, W] bool
    bg_img: np.ndarray       # [H, W, 3]
    intrinsics: tuple
    H: int
    W: int
    device: torch.device = torch.device("cpu")
    images_dev: torch.Tensor | None = None   # preload=2: [N, H·W, 3] uint8
    masks_dev: torch.Tensor | None = None    # preload=2: [N, H·W] bool
    bg_dev: torch.Tensor | None = None       # preload=2: [H·W, 3] float32
    torso_imgs: np.ndarray | None = None     # [N, H, W, 4] float32 RGBA (torso_imgs/)
    lips_rects: np.ndarray | None = None     # [N, 4] int32 (rmin, rmax, cmin, cmax) (.lms)

    def __len__(self) -> int:
        return len(self.poses)

    def sample_lips_rays(self, index: int, rng: np.random.Generator, size: int = 64,
                         att_window: int = 8) -> dict:
        """The lips fine-tuning batch of frame ``index``: the size×size
        window centred on the frame's lips rect and clamped into the frame,
        row-major (the JAX package's static window, where the reference
        takes each frame's own rect). rng is not drawn from. The colours
        come from the host's frames at every preload tier, as in JAX.
        Tensors on ``self.device``."""
        if self.lips_rects is None:
            raise ValueError("the dataset has no lips rects (.lms landmark files)")
        rmin, rmax, cmin, cmax = self.lips_rects[index]
        half = size // 2
        r0 = int(np.clip((rmin + rmax) // 2 - half, 0, self.H - size))
        c0 = int(np.clip((cmin + cmax) // 2 - half, 0, self.W - size))
        dy, dx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        sel = ((r0 + dy) * self.W + (c0 + dx)).reshape(-1)
        return self._batch(index, sel, att_window, host_colours=True)

    def sample_torso_rays(self, index: int, num_rays: int, rng: np.random.Generator) -> dict:
        """One torso-stage batch of num_rays random pixels of frame
        ``index``, drawn with the same generator calls as the JAX package:
        pixel centres in [−1, 1]² (coords), the torso image alpha-blended
        onto the background (bg_torso_color, the target), the background
        (bg_color), the head pose and the index. Tensors on ``self.device``."""
        if self.torso_imgs is None:
            raise ValueError("the dataset has no torso_imgs/ directory")
        sel = rng.integers(0, self.H * self.W, size=num_rays)
        ys, xs = sel // self.W, sel % self.W
        coords = np.stack([(xs + 0.5) / self.W * 2 - 1, (ys + 0.5) / self.H * 2 - 1],
                          -1).astype(np.float32)
        torso = self.torso_imgs[index].reshape(-1, 4)[sel]
        bg = self.bg_img.reshape(-1, 3)[sel]
        gt = torso[:, :3] * torso[:, 3:] + bg * (1 - torso[:, 3:])
        dev = self.device
        return {"coords": torch.from_numpy(coords).to(dev),
                "bg_torso_color": torch.from_numpy(gt.astype(np.float32)).to(dev),
                "bg_color": torch.from_numpy(bg.astype(np.float32)).to(dev),
                "pose": torch.from_numpy(self.poses[index]).to(dev),
                "index": int(index)}

    def sample_rays(self, index: int, num_rays: int, rng: np.random.Generator,
                    att_window: int = 8, patch_size: int | None = None) -> dict:
        """One training batch of num_rays random pixels of frame ``index``,
        drawn with the same generator calls as the JAX package, so a seed
        gives the same pixels. With ``patch_size``, num_rays / patch_size²
        square patches instead, each row-major, one after the other (the
        layout the LPIPS term reshapes). Tensors on ``self.device``."""
        if patch_size is not None:
            ps = patch_size
            num_patch = num_rays // (ps * ps)
            if num_patch * ps * ps != num_rays:
                raise ValueError(f"num_rays {num_rays} is not a multiple of patch_size² "
                                 f"({ps}²)")
            tl_y = rng.integers(0, self.H - ps, size=num_patch)
            tl_x = rng.integers(0, self.W - ps, size=num_patch)
            dy, dx = np.meshgrid(np.arange(ps), np.arange(ps), indexing="ij")
            sel = ((tl_y[:, None, None] + dy[None]) * self.W
                   + (tl_x[:, None, None] + dx[None])).reshape(-1)
        else:
            sel = rng.integers(0, self.H * self.W, size=num_rays)
        return self._batch(index, sel, att_window)

    def _batch(self, index: int, sel: np.ndarray, att_window: int,
               host_colours: bool = False) -> dict:
        """The rays, colours, background and face mask of frame ``index``'s
        pixels ``sel``, with the frame's audio window, eye and index. Under
        preload 2 the gathers run on the device, unless ``host_colours``."""
        from mere_fusion_tpu_torch.models.ernerf.renderer import get_rays

        dev = self.device
        pose = torch.from_numpy(self.poses[index]).to(dev)
        rays_o, rays_d = get_rays(pose, self.intrinsics, self.H, self.W)
        idx = np.clip(np.arange(index - att_window // 2, index + att_window // 2),
                      0, len(self) - 1)
        sel_t = torch.from_numpy(sel).to(dev)
        batch = {
            "rays_o": rays_o[sel_t],
            "rays_d": rays_d[sel_t],
            "auds": torch.from_numpy(self.auds[idx]).to(dev),
            "eye": torch.tensor([[self.eye_area[index]]], dtype=torch.float32, device=dev),
            "index": int(index),
        }
        if self.images_dev is not None and not host_colours:
            # preload=2: the gathers run on the device; only sel is shipped
            batch["rgb"] = self.images_dev[index][sel_t].float() / 255.0
            batch["bg_color"] = self.bg_dev[sel_t]
            batch["face_mask"] = self.masks_dev[index][sel_t]
            return batch
        batch["rgb"] = torch.from_numpy(self.images[index].reshape(-1, 3)[sel]).to(dev)
        batch["bg_color"] = torch.from_numpy(self.bg_img.reshape(-1, 3)[sel]).to(dev)
        batch["face_mask"] = torch.from_numpy(self.face_masks[index].reshape(-1)[sel]).to(dev)
        return batch

    @classmethod
    def load(cls, root: str, scale: float = 4.0, offset=(0, 0, 0), bg_img: str = "white",
             preload: int = 1, device=None) -> "NeRFTrainDataset":
        """Load an ER-NeRF-format data dir: transforms.json (frames with
        img_id/aud_id), gt_imgs/{img_id}.jpg|png, aud.npy [N, 16, A] or
        [N, A, 16] features, au.csv blink areas, optional
        parsing/{img_id}.png face masks (else the centre half of the frame),
        optional torso_imgs/{img_id}.png BGRA torso images (read at every
        preload tier), optional {img_id}.lms landmarks (68 × (x, y) pixels)
        under ori_imgs/ or gt_imgs/: when frame 0 has one, every frame must,
        and each frame's lips rect is the square around landmarks 48–59.
        ``device`` None means the current CUDA device."""
        if preload not in (0, 1, 2):
            raise ValueError(f"preload is 0, 1 or 2, got {preload}")
        device = resolve_device(device)
        with open(os.path.join(root, "transforms.json")) as f:
            transform = json.load(f)
        H = int(transform["cy"]) * 2
        W = int(transform["cx"]) * 2
        aud_features = np.load(os.path.join(root, "aud.npy"))
        if aud_features.ndim == 3 and aud_features.shape[1] == 16:
            aud_features = aud_features.transpose(0, 2, 1)   # [N, 16, A] → [N, A, 16]
        au_blink = read_au45(os.path.join(root, "au.csv"))

        poses, images, auds, eyes, masks, img_paths = [], [], [], [], [], []
        for fr in transform["frames"]:
            poses.append(nerf_matrix_to_ngp(
                np.array(fr["transform_matrix"], np.float32), scale, offset))
            img_id = fr["img_id"]
            for ext in (".jpg", ".png"):
                p = os.path.join(root, "gt_imgs", f"{img_id}{ext}")
                if os.path.exists(p):
                    break
            img_paths.append(p)
            if preload >= 1:
                img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                images.append(img.astype(np.float32) / 255)
            auds.append(aud_features[min(fr.get("aud_id", img_id), len(aud_features) - 1)])
            eyes.append(float(np.clip(au_blink[img_id], 0, 2)) / 2)
            mp = os.path.join(root, "parsing", f"{img_id}.png")
            if os.path.exists(mp):
                parsing = cv2.imread(mp)
                # semantic maps: the head is BGR (255, 0, 0)
                masks.append((parsing[..., 0] > 200) & (parsing[..., 2] < 100))
            else:
                m = np.zeros((H, W), bool)
                m[H // 4: 3 * H // 4, W // 4: 3 * W // 4] = True
                masks.append(m)

        if bg_img == "white":
            bg = np.ones((H, W, 3), np.float32)
        else:
            bg = cv2.cvtColor(cv2.imread(bg_img), cv2.COLOR_BGR2RGB).astype(np.float32) / 255
        torso = None
        torso_dir = os.path.join(root, "torso_imgs")
        if os.path.isdir(torso_dir):
            torso = np.stack([
                cv2.cvtColor(cv2.imread(os.path.join(torso_dir, f"{fr['img_id']}.png"),
                                        cv2.IMREAD_UNCHANGED),
                             cv2.COLOR_BGRA2RGBA).astype(np.float32) / 255
                for fr in transform["frames"]])
        lips = read_lips_rects(root, transform["frames"], H, W)
        image_store = LazyFrames(img_paths) if preload == 0 else np.stack(images)
        face_masks = np.stack(masks)
        images_dev = masks_dev = bg_dev = None
        if preload == 2:
            n = len(img_paths)
            images_dev = torch.from_numpy(
                np.rint(image_store * 255).astype(np.uint8).reshape(n, H * W, 3)).to(device)
            masks_dev = torch.from_numpy(face_masks.reshape(n, H * W)).to(device)
            bg_dev = torch.from_numpy(bg.reshape(H * W, 3).astype(np.float32)).to(device)
        fl = transform["focal_len"]
        return cls(poses=np.stack(poses), images=image_store,
                   auds=np.stack(auds).astype(np.float32),
                   eye_area=np.asarray(eyes, np.float32), face_masks=face_masks, bg_img=bg,
                   intrinsics=(fl, fl, transform["cx"], transform["cy"]), H=H, W=W,
                   device=device, images_dev=images_dev, masks_dev=masks_dev, bg_dev=bg_dev,
                   torso_imgs=torso, lips_rects=lips)


def read_lips_rects(root: str, frames: list, H: int, W: int) -> np.ndarray | None:
    """Each frame's squared lips rect [N, 4] int32 (rmin, rmax, cmin, cmax)
    from its ``{img_id}.lms`` under ori_imgs/ or gt_imgs/, or None when
    frame 0 has none. The rect's rows come from the landmarks' y (the
    reference calls the row axis x); its side is the larger extent of
    landmarks 48–59, clipped to the frame. A frame without a file raises
    FileNotFoundError."""
    dirs = [os.path.join(root, d) for d in ("ori_imgs", "gt_imgs")]
    dirs = [d for d in dirs if os.path.isdir(d)]

    def find(img_id):
        return next((p for d in dirs for p in [os.path.join(d, f"{img_id}.lms")]
                     if os.path.exists(p)), None)

    if find(frames[0]["img_id"]) is None:
        return None
    lips = []
    for fr in frames:
        path = find(fr["img_id"])
        if path is None:
            raise FileNotFoundError(f"frame {fr['img_id']} has no .lms landmark file "
                                    f"(searched {dirs})")
        lms = np.loadtxt(path)[48:60]
        rmin, rmax = int(lms[:, 1].min()), int(lms[:, 1].max())
        cmin, cmax = int(lms[:, 0].min()), int(lms[:, 0].max())
        cy, cx = (rmin + rmax) // 2, (cmin + cmax) // 2
        half = max(rmax - rmin, cmax - cmin) // 2
        lips.append([max(0, cy - half), min(H, cy + half), max(0, cx - half), min(W, cx + half)])
    return np.asarray(lips, np.int32)


def synthesize_nerf_train_data(dirpath: str, n_frames: int = 4, hw: int = 64,
                               audio_dim: int = 44, scale: float = 1.0) -> str:
    """Procedural ER-NeRF training data dir: a moving bright square over
    gray, with matching aud.npy and au.csv (with the default scale the JAX
    package's twin writes the same files)."""
    synthesize_nerf_dataset(dirpath, n_frames, hw, scale)
    gt = os.path.join(dirpath, "gt_imgs")
    os.makedirs(gt, exist_ok=True)
    for i in range(n_frames):
        img = np.full((hw, hw, 3), 64, np.uint8)
        o = hw // 4 + i
        img[o: o + hw // 2, o: o + hw // 2] = [220, 180, 140]
        cv2.imwrite(os.path.join(gt, f"{i}.png"), img)
    rng = np.random.default_rng(0)
    np.save(os.path.join(dirpath, "aud.npy"),
            rng.standard_normal((n_frames, 16, audio_dim)).astype(np.float32))
    return dirpath


def synthesize_nerf_dataset(dirpath: str, n_frames: int = 4, hw: int = 64,
                            scale: float = 1.0) -> str:
    """Write a small procedural transforms.json + au.csv: a short orbit 1.5
    from the origin, looking at it, authored in NGP space and converted back
    so that loading with ``scale`` reproduces it exactly (the box then fills
    the frame)."""
    os.makedirs(dirpath, exist_ok=True)
    frames = []
    for i in range(n_frames):
        angle = 0.08 * i
        c, s = np.cos(angle), np.sin(angle)
        post = np.array(
            [
                [c, 0.0, s, 1.5 * s],
                [0.0, 1.0, 0.0, 0.0],
                [-s, 0.0, c, 1.5 * c],
                [0.0, 0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        mat = ngp_to_nerf_matrix(post, scale=scale).tolist()
        frames.append({"img_id": i, "aud_id": i, "transform_matrix": mat})
    pose_path = os.path.join(dirpath, "transforms.json")
    with open(pose_path, "w") as f:
        json.dump({"cx": hw / 2, "cy": hw / 2, "focal_len": hw * 1.2, "frames": frames}, f)
    write_au_csv(os.path.join(dirpath, "au.csv"), n_frames)
    return dirpath


def write_au_csv(path: str, n_frames: int) -> str:
    """A procedural au.csv as OpenFace writes it: the AU45_r blink column
    the loaders read, 25 fps timestamps."""
    with open(path, "w") as f:
        f.write("frame, face_id, timestamp, confidence, success, AU45_r\n")
        for i in range(n_frames):
            f.write(f"{i+1}, 0, {i*0.04:.3f}, 0.98, 1, {0.2 + 0.1 * (i % 3):.2f}\n")
    return path
