"""Scene-text OCR: CRAFT-style detector + CRNN recognizer.

Port of mere_fusion_tpu/models/ocr.py. The reference reads on-screen text
with EasyOCR (``easyocr.Reader(['en', 'ch_sim']).readtext(frame)``,
yolo_opencv.py:189-199) and folds it into the LLM's scene summary. Its two
networks, NCHW:

- ``CRAFT``: a VGG16-BN backbone whose stage outputs feed a U-Net decoder of
  ``double_conv`` blocks, ending in a 2-channel half-resolution map
  (character region score, inter-character affinity score);
- ``CRNN``: EasyOCR's "None-VGG-BiLSTM-CTC" recognizer (english_g2): a VGG
  feature extractor, the height averaged away, two bidirectional
  ``nn.LSTM``s with projections, a linear CTC head.

Modules are named as the flax ones with dots (``s1_0.conv``, ``up_0.bn_1``,
``rnn_0.lstm.weight_ih_l0_reverse``); ``utils/torch_convert.convert_craft``
and ``convert_crnn`` map EasyOCR's checkpoints onto them by order. The
detector reads a square canvas of a ``DET_SIZES`` side with the frame at its
top left; the recognizer reads crops resized to ``REC_HEIGHT`` and
zero-padded to a ``REC_WIDTH_BUCKETS`` width, a tail the BiLSTM reads. The
map's thresholding and component grouping run on the host (cv2).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import device_scope, random_init_, resolve_device

# EasyOCR english_g2 alphabet: blank (CTC index 0) + these characters
DEFAULT_CHARSET = (
    "0123456789!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
)

# recognizer input height and width buckets (crops wider than the last
# bucket are squeezed into it)
REC_HEIGHT = 64
REC_WIDTH_BUCKETS = (64, 128, 256, 512)

# detector canvas sides (the long side's bucket), multiples of 32
DET_SIZES = (320, 640, 960)

_CRAFT_STAGES = ((64, 2, "s1"), (128, 2, "s2"), (256, 3, "s3"), (512, 3, "s4"), (512, 3, "s5"))


def _width(width: float):
    return lambda n: max(int(round(n * width)), 4)


class _ConvBN(nn.Module):
    """3×3 conv + BatchNorm (eps 1e-5) + ReLU (VGG16-BN building block)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _DoubleConv(nn.Module):
    """CRAFT decoder block: 1×1 conv to mid, 3×3 conv to out, BN+ReLU each."""

    def __init__(self, cin: int, mid: int, out: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(cin, mid, 1)
        self.bn_0 = nn.BatchNorm2d(mid, eps=1e-5)
        self.conv_1 = nn.Conv2d(mid, out, 3, padding=1)
        self.bn_1 = nn.BatchNorm2d(out, eps=1e-5)

    def forward(self, x):
        x = F.relu(self.bn_0(self.conv_0(x)))
        return F.relu(self.bn_1(self.conv_1(x)))


class CRAFT(nn.Module):
    """Region + affinity text detector. Input [N, 3, H, W] float32,
    ImageNet-normalised; output [N, 2, H/2, W/2] logits (the caller applies
    the sigmoid). ``width`` scales channels (published file: 1.0)."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        c = _width(width)
        cin = 3
        for ch, reps, name in _CRAFT_STAGES:
            for i in range(reps):
                setattr(self, f"{name}_{i}", _ConvBN(cin, c(ch)))
                cin = c(ch)
        self.fc6 = nn.Conv2d(cin, c(1024), 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(c(1024), c(1024), 1)
        self.up_0 = _DoubleConv(c(1024) + c(512), c(512), c(256))
        self.up_1 = _DoubleConv(c(256) + c(512), c(256), c(128))
        self.up_2 = _DoubleConv(c(128) + c(256), c(128), c(64))
        self.up_3 = _DoubleConv(c(64) + c(128), c(64), c(32))
        self.cls_0 = nn.Conv2d(c(32), c(32), 3, padding=1)
        self.cls_1 = nn.Conv2d(c(32), c(32), 3, padding=1)
        self.cls_2 = nn.Conv2d(c(32), c(16), 3, padding=1)
        self.cls_3 = nn.Conv2d(c(16), c(16), 1)
        self.cls_4 = nn.Conv2d(c(16), 2, 1)

    def forward(self, x):
        f = {}
        for _ch, reps, name in _CRAFT_STAGES:
            for i in range(reps):
                x = getattr(self, f"{name}_{i}")(x)
            f[name] = x
            if name != "s5":
                x = F.max_pool2d(x, 2, 2)                # /2 /4 /8 /16
        # fc6/fc7 at /16: a stride-1 pool (-inf padding), dilated 3×3, 1×1
        x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))

        def up_to(y, like):   # an exact 2× bilinear upsample, half-pixel centres
            return F.interpolate(y, size=like.shape[2:], mode="bilinear", align_corners=False)

        y = self.up_0(torch.cat([x, f["s5"]], 1))
        y = self.up_1(torch.cat([up_to(y, f["s4"]), f["s4"]], 1))
        y = self.up_2(torch.cat([up_to(y, f["s3"]), f["s3"]], 1))
        y = self.up_3(torch.cat([up_to(y, f["s2"]), f["s2"]], 1))
        y = F.relu(self.cls_0(y))
        y = F.relu(self.cls_1(y))
        y = F.relu(self.cls_2(y))
        y = F.relu(self.cls_3(y))
        return self.cls_4(y)


class BiLSTM(nn.Module):
    """Bidirectional LSTM + linear projection (deep-text-recognition's
    BidirectionalLSTM: LSTM(in, hidden, bidirectional) → Linear(2h, out))."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__()
        self.lstm = nn.LSTM(cin, hidden, bidirectional=True)
        self.proj = nn.Linear(2 * hidden, out)

    def forward(self, xs):  # [T, N, I]
        return self.proj(self.lstm(xs)[0])


class CRNN(nn.Module):
    """VGG–BiLSTM–CTC text recognizer (EasyOCR english_g2 topology).

    Input [N, 1, H, W] float32 in [-1, 1] (EasyOCR's (x - 0.5) / 0.5); output
    [N, T, n_classes] CTC logits, T = W/4 - 1. Class 0 is the blank."""

    def __init__(self, n_classes: int = 1 + len(DEFAULT_CHARSET), output_channel: int = 256,
                 hidden: int = 256):
        super().__init__()
        oc = output_channel
        ch = (oc // 8, oc // 4, oc // 2, oc)
        self.conv_0 = nn.Conv2d(1, ch[0], 3, padding=1)
        self.conv_1 = nn.Conv2d(ch[0], ch[1], 3, padding=1)
        self.conv_2 = nn.Conv2d(ch[1], ch[2], 3, padding=1)
        self.conv_3 = nn.Conv2d(ch[2], ch[2], 3, padding=1)
        self.conv_4 = nn.Conv2d(ch[2], ch[3], 3, padding=1, bias=False)
        self.bn_4 = nn.BatchNorm2d(ch[3], eps=1e-5)
        self.conv_5 = nn.Conv2d(ch[3], ch[3], 3, padding=1, bias=False)
        self.bn_5 = nn.BatchNorm2d(ch[3], eps=1e-5)
        self.conv_6 = nn.Conv2d(ch[3], ch[3], 2)
        self.rnn_0 = BiLSTM(ch[3], hidden, hidden)
        self.rnn_1 = BiLSTM(hidden, hidden, hidden)
        self.head = nn.Linear(hidden, n_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv_0(x)), 2, 2)              # H/2, W/2
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2, 2)              # H/4, W/4
        x = F.relu(self.conv_2(x))
        x = F.max_pool2d(F.relu(self.conv_3(x)), (2, 1), (2, 1))    # H/8
        x = F.relu(self.bn_4(self.conv_4(x)))
        x = F.max_pool2d(F.relu(self.bn_5(self.conv_5(x))), (2, 1), (2, 1))   # H/16
        x = F.relu(self.conv_6(x))
        xs = x.mean(dim=2).permute(2, 0, 1)     # AdaptiveAvgPool over H → [T, N, C]
        xs = self.rnn_1(self.rnn_0(xs))
        return self.head(xs).transpose(0, 1)    # [N, T, classes]


def ctc_greedy(ids: np.ndarray, charset: str = DEFAULT_CHARSET) -> str:
    """Collapse repeats then drop blanks (index 0)."""
    out, prev = [], 0
    for t in np.asarray(ids).tolist():
        if t != prev and t != 0:
            out.append(charset[t - 1])
        prev = t
    return "".join(out)


# ImageNet normalisation of CRAFT/EasyOCR's detection preprocessing
_DET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_DET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _build(module: nn.Module, state, device, seed: int) -> nn.Module:
    module.to_empty(device=device)
    if state is None:
        random_init_(module, seed)
    else:
        module.load_state_dict(state, strict=True)
    return module.eval()


class TextReader:
    """Host wrapper with EasyOCR's ``readtext`` contract: BGR frame →
    ``[(quad_box, text, confidence), ...]`` (the reference takes ``t[1]``,
    yolo_opencv.py:195-199).

    ``det_state``/``rec_state`` are the port's CRAFT/CRNN state dicts
    (``utils/torch_convert.convert_craft``/``convert_crnn`` of EasyOCR's
    files), seeded random weights without them; ``width`` scales the
    detector. One CRAFT pass a frame, one CRNN pass a width bucket."""

    def __init__(self, det_state=None, rec_state=None, charset: str = DEFAULT_CHARSET,
                 width: float = 1.0, text_threshold: float = 0.7, link_threshold: float = 0.4,
                 low_text: float = 0.4, seed: int = 0, device=None):
        self.charset = charset
        self.text_threshold = text_threshold
        self.link_threshold = link_threshold
        self.low_text = low_text
        self.device = resolve_device(device)
        with torch.device("meta"):
            det, rec = CRAFT(width=width), CRNN(n_classes=1 + len(charset))
        with device_scope(self.device):
            self.det = _build(det, det_state, self.device, seed)
            self.rec = _build(rec, rec_state, self.device, seed)

    # -- detection ---------------------------------------------------------
    def detection_canvas(self, frame_bgr: np.ndarray) -> tuple[np.ndarray, float]:
        """The normalised square canvas [S, S, 3] (RGB, frame at the top
        left) and the frame's scale onto it."""
        import cv2

        h, w = frame_bgr.shape[:2]
        long_side = max(h, w)
        size = next((s for s in DET_SIZES if s >= long_side), DET_SIZES[-1])
        scale = size / long_side
        rh, rw = int(round(h * scale)), int(round(w * scale))
        canvas = np.zeros((size, size, 3), np.float32)
        rgb = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB).astype(np.float32)
        canvas[:rh, :rw] = cv2.resize(rgb, (rw, rh)) / 255.0
        return (canvas - _DET_MEAN) / _DET_STD, scale

    @torch.no_grad()
    def detection_maps(self, canvas: np.ndarray) -> np.ndarray:
        """Canvas [S, S, 3] → the sigmoid maps [S/2, S/2, 2] (region,
        affinity) on the host."""
        with device_scope(self.device):
            x = torch.from_numpy(canvas).to(self.device).permute(2, 0, 1)[None]
            return self.det(x)[0].sigmoid().permute(1, 2, 0).cpu().numpy()

    def boxes_from_maps(self, maps: np.ndarray, scale: float) -> list[np.ndarray]:
        """EasyOCR getDetBoxes' core on the host: the connected components
        of (region > low_text | affinity > link_threshold), kept when their
        area is 6 or more and their peak region score clears text_threshold,
        each as its min-area rectangle grown by 2 px a side, in frame pixels."""
        import cv2

        region, affinity = maps[..., 0], maps[..., 1]
        mask = ((region > self.low_text) | (affinity > self.link_threshold)).astype(np.uint8)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(mask, 4)
        boxes = []
        for k in range(1, n):
            comp = labels == k
            if stats[k, cv2.CC_STAT_AREA] < 6:
                continue
            if float(region[comp].max()) < self.text_threshold:
                continue
            ys, xs = np.nonzero(comp)
            pts = np.stack([xs, ys], 1).astype(np.float32)
            rect = cv2.minAreaRect(pts)
            quad = cv2.boxPoints((rect[0], (rect[1][0] + 4, rect[1][1] + 4), rect[2]))
            boxes.append(quad * 2.0 / scale)  # the map is half resolution
        return boxes

    def detect(self, frame_bgr: np.ndarray) -> list[np.ndarray]:
        """Quad boxes (4, 2) float32 in frame pixels."""
        canvas, scale = self.detection_canvas(frame_bgr)
        return self.boxes_from_maps(self.detection_maps(canvas), scale)

    # -- recognition -------------------------------------------------------
    @staticmethod
    def prep_crop(gray: np.ndarray) -> tuple[np.ndarray, int]:
        """A grayscale crop → [REC_HEIGHT, bucket] in [-1, 1], zeros after
        the resized crop, and its bucket width."""
        import cv2

        h, w = gray.shape[:2]
        tw = max(int(round(w * REC_HEIGHT / max(h, 1))), 8)
        bucket = next((b for b in REC_WIDTH_BUCKETS if b >= tw), REC_WIDTH_BUCKETS[-1])
        tw = min(tw, bucket)
        img = cv2.resize(gray, (tw, REC_HEIGHT)).astype(np.float32)
        out = np.zeros((REC_HEIGHT, bucket), np.float32)
        out[:, :tw] = (img / 255.0 - 0.5) / 0.5
        return out, bucket

    @torch.no_grad()
    def recognize(self, crops: Sequence[np.ndarray]) -> list[tuple[str, float]]:
        """Grayscale crops → (text, mean token confidence) each; the crops of
        one width bucket run as one batch."""
        by_bucket: dict[int, list[tuple[int, np.ndarray]]] = {}
        for i, g in enumerate(crops):
            img, bucket = self.prep_crop(g)
            by_bucket.setdefault(bucket, []).append((i, img))
        results: dict[int, tuple[str, float]] = {}
        with device_scope(self.device):
            for items in by_bucket.values():
                x = torch.from_numpy(np.stack([img for _, img in items])[:, None])
                logits = self.rec(x.to(self.device))
                ids = logits.argmax(-1).cpu().numpy()
                conf = logits.softmax(-1).amax(-1).cpu().numpy()
                for j, (i, _) in enumerate(items):
                    results[i] = (ctc_greedy(ids[j], self.charset), float(conf[j].mean()))
        return [results[i] for i in range(len(crops))]

    def readtext(self, frame_bgr: np.ndarray) -> list[tuple]:
        """EasyOCR contract: [(4-point box, text, confidence), ...]."""
        import cv2

        boxes = self.detect(frame_bgr)
        if not boxes:
            return []
        gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
        h, w = gray.shape
        crops, kept = [], []
        for quad in boxes:
            x1 = int(max(quad[:, 0].min(), 0))
            y1 = int(max(quad[:, 1].min(), 0))
            x2 = int(min(quad[:, 0].max(), w))
            y2 = int(min(quad[:, 1].max(), h))
            if x2 - x1 < 4 or y2 - y1 < 4:
                continue
            crops.append(gray[y1:y2, x1:x2])
            kept.append(quad)
        texts = self.recognize(crops)
        return [(q.tolist(), t, c) for q, (t, c) in zip(kept, texts) if t]
