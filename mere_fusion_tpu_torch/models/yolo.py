"""YOLOv10 object detector: the perception plane's detector.

Port of mere_fusion_tpu/models/yolo.py (reference: yolo_opencv.py:42,
152-158, ``YOLO("yolov10x.pt")`` then ``results[0].boxes``). NCHW modules
built from the same layer spec as the upstream yaml, at every scale of
``SCALES``:

  backbone  Conv ×2 → C2f → Conv → C2f → SCDown → C2fCIB → SCDown → C2fCIB
            → SPPF → PSA
  head      PAN (upsample/concat + C2f/C2fCIB + Conv/SCDown legs)
            → v10Detect's one-to-one branch (NMS-free: top-k, no NMS pass)

Submodules carry ultralytics' names (``model.{i}.cv1.conv.weight``,
``model.{i}.m.0.cv1.bn.running_var``, ``model.23.one2one_cv2.0.1.conv.weight``
…), so a checkpoint's state dict, with the one-to-many training head and the
constant DFL conv dropped (``utils/yolo_convert.convert_yolo``), loads with
strict key checks. In bfloat16 the convolutions' weights are bf16 and the
BatchNorm statistics stay float32; the PSA attention, the DFL decode and the
class sigmoid run in float32.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mere_fusion_tpu_torch.device import device_scope, random_init_, resolve_device

# (depth, width, max_channels): ultralytics' compound-scaling table
SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "b": (0.67, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

# (from, repeats, module, args) as in the upstream yaml; args carry yaml-scale
# channel counts, to which scale_channels / scale_depth apply the scale
YOLOV10_SPEC: tuple = (
    # backbone
    (-1, 1, "Conv", (64, 3, 2)),        # 0  P1/2
    (-1, 1, "Conv", (128, 3, 2)),       # 1  P2/4
    (-1, 3, "C2f", (128, True)),        # 2
    (-1, 1, "Conv", (256, 3, 2)),       # 3  P3/8
    (-1, 6, "C2f", (256, True)),        # 4
    (-1, 1, "SCDown", (512, 3, 2)),     # 5  P4/16
    (-1, 6, "C2fCIB", (512, True)),     # 6
    (-1, 1, "SCDown", (1024, 3, 2)),    # 7  P5/32
    (-1, 3, "C2fCIB", (1024, True)),    # 8
    (-1, 1, "SPPF", (1024, 5)),         # 9
    (-1, 1, "PSA", (1024,)),            # 10
    # head (PAN)
    (-1, 1, "Upsample", ()),            # 11
    ((-1, 6), 1, "Concat", ()),         # 12  cat backbone P4
    (-1, 3, "C2fCIB", (512, True)),     # 13
    (-1, 1, "Upsample", ()),            # 14
    ((-1, 4), 1, "Concat", ()),         # 15  cat backbone P3
    (-1, 3, "C2f", (256,)),             # 16  P3/8 small
    (-1, 1, "Conv", (256, 3, 2)),       # 17
    ((-1, 13), 1, "Concat", ()),        # 18  cat head P4
    (-1, 3, "C2fCIB", (512, True)),     # 19  P4/16 medium
    (-1, 1, "SCDown", (512, 3, 2)),     # 20
    ((-1, 10), 1, "Concat", ()),        # 21  cat head P5
    (-1, 3, "C2fCIB", (1024, True)),    # 22  P5/32 large
    ((16, 19, 22), 1, "Detect", ()),    # 23  v10Detect (one-to-one branch)
)

STRIDES = (8, 16, 32)
REG_MAX = 16

COCO_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


def scale_channels(c: int, width: float, max_channels: int) -> int:
    """yaml channels → real channels (ultralytics make_divisible by 8)."""
    return int(math.ceil(min(c, max_channels) * width / 8) * 8)


def scale_depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n


class ConvBN(nn.Module):
    """ultralytics Conv: Conv2d(bias=False) + BatchNorm(eps 1e-3) + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0])
        self.cv2 = ConvBN(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block: split, n bottlenecks, concat, fuse."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, (3, 3), 1.0)
                               for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max pools, which
    pad with -inf."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class SCDown(nn.Module):
    """Spatial-channel decoupled downsample: 1×1 pointwise then k×k dw."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = ConvBN(c1, c2, 1, 1)
        self.cv2 = ConvBN(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class RepVGGDW(nn.Module):
    """7×7 + 3×3 depthwise branches summed (unfused training-form weights)."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = ConvBN(ed, ed, 7, 1, g=ed, act=False)
        self.conv1 = ConvBN(ed, ed, 3, 1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    """Compact inverted block (dw-pw-dw/lk-pw-dw) with residual add."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            ConvBN(c1, c1, 3, g=c1),
            ConvBN(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else ConvBN(2 * c_, 2 * c_, 3, g=2 * c_),
            ConvBN(2 * c_, c2, 1),
            ConvBN(c2, c2, 3, g=c2),
        )
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 lk: bool = False):
        super().__init__(c1, c2, n, shortcut)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class Attention(nn.Module):
    """v10 PSA attention: per-head q, k, v from a 1×1 conv, channels
    head-major (each head's [q | k | v] contiguous), softmax(qᵀk·key_dim^-½)
    over keys in float32, plus a depthwise positional conv of v."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        qkv = self.qkv(x).float().view(b, self.num_heads, 2 * self.key_dim + self.head_dim,
                                       h * w)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w).to(x.dtype)
        return self.proj(out + self.pe(v.reshape(b, c, h, w).to(x.dtype)))


class PSA(nn.Module):
    """Partial self-attention: attention + conv-FFN on half the channels."""

    def __init__(self, c1: int, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1)
        self.cv2 = ConvBN(2 * self.c, c1, 1)
        self.attn = Attention(self.c, num_heads=max(self.c // 64, 1), attn_ratio=0.5)
        self.ffn = nn.Sequential(ConvBN(self.c, 2 * self.c, 1),
                                 ConvBN(2 * self.c, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


def make_anchors(imgsz: int) -> tuple[np.ndarray, np.ndarray]:
    """Anchor centres (grid units, +0.5) and per-anchor strides, all levels
    flattened row-major (y, x), as torch make_anchors orders them."""
    pts, strides = [], []
    for s in STRIDES:
        hw = imgsz // s
        sx = np.arange(hw, dtype=np.float32) + 0.5
        gy, gx = np.meshgrid(sx, sx, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(np.full((hw * hw, 1), s, np.float32))
    return np.concatenate(pts, 0), np.concatenate(strides, 0)


@functools.lru_cache(maxsize=None)
def _anchor_tensors(imgsz: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    anchors, strides = make_anchors(imgsz)
    return torch.from_numpy(anchors).to(device), torch.from_numpy(strides).to(device)


class V10Detect(nn.Module):
    """v10Detect's one-to-one branch (the inference path, NMS-free). A
    checkpoint's one-to-many branch (cv2/cv3) and DFL conv are not built."""

    def __init__(self, nc: int, ch: Sequence[int]):
        super().__init__()
        self.nc = nc
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.one2one_cv2 = nn.ModuleList(
            nn.Sequential(ConvBN(x, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for x in ch)
        self.one2one_cv3 = nn.ModuleList(
            nn.Sequential(nn.Sequential(ConvBN(x, x, 3, g=x), ConvBN(x, c3, 1)),
                          nn.Sequential(ConvBN(c3, c3, 3, g=c3), ConvBN(c3, c3, 1)),
                          nn.Conv2d(c3, nc, 1))
            for x in ch)

    def forward(self, feats):
        """→ (box logits [B, A, 64], class logits [B, A, nc]) over all A
        anchors, levels concatenated."""
        boxes, scores = [], []
        for i, x in enumerate(feats):
            boxes.append(self.one2one_cv2[i](x).flatten(2).transpose(1, 2))
            scores.append(self.one2one_cv3[i](x).flatten(2).transpose(1, 2))
        return torch.cat(boxes, 1), torch.cat(scores, 1)


def dfl_decode(box_logits: torch.Tensor, anchors: torch.Tensor,
               strides: torch.Tensor) -> torch.Tensor:
    """DFL bins → (l, t, r, b) distances → xyxy in input pixels, in float32
    (softmax over 16 bins, expectation, dist2bbox)."""
    b, n, _ = box_logits.shape
    p = box_logits.float().view(b, n, 4, REG_MAX).softmax(-1)
    dist = (p * torch.arange(REG_MAX, dtype=torch.float32, device=p.device)).sum(-1)
    lt, rb = dist[..., :2], dist[..., 2:]
    return torch.cat([anchors - lt, anchors + rb], -1) * strides


class YoloV10(nn.Module):
    """Spec-driven YOLOv10. ``forward`` returns (boxes_xyxy, scores, classes)
    of the top ``max_det`` (anchor, class) pairs: top anchors by their best
    class score, then top pairs among them (torch Detect.postprocess);
    ``raw=True`` returns (boxes, scores) of every anchor instead.

    ``dtype`` is the convolutions' weight dtype (BatchNorm stays float32)."""

    def __init__(self, scale: str = "x", nc: int = 80, imgsz: int = 640, max_det: int = 300,
                 spec: tuple = YOLOV10_SPEC, dtype: torch.dtype = torch.float32):
        super().__init__()
        depth, width, max_ch = SCALES[scale]
        cc = functools.partial(scale_channels, width=width, max_channels=max_ch)
        self.nc, self.imgsz, self.max_det, self.spec, self.dtype = nc, imgsz, max_det, spec, dtype
        layers, chans, c_in = [], [], 3
        for frm, n, mod, args in spec:
            if mod == "Concat":
                layers.append(nn.Identity())
                c_in = sum(chans[j] if j != -1 else c_in for j in frm)
            elif mod == "Upsample":
                layers.append(nn.Identity())
            elif mod == "Detect":
                layers.append(V10Detect(nc, [chans[j] for j in frm]))
                break
            else:
                c2 = cc(args[0])
                shortcut = bool(args[1]) if len(args) > 1 else False
                if mod == "Conv":
                    layers.append(ConvBN(c_in, c2, args[1], args[2]))
                elif mod == "SCDown":
                    layers.append(SCDown(c_in, c2, args[1], args[2]))
                elif mod == "C2f":
                    layers.append(C2f(c_in, c2, scale_depth(n, depth), shortcut))
                elif mod == "C2fCIB":
                    layers.append(C2fCIB(c_in, c2, scale_depth(n, depth), shortcut,
                                         lk=bool(args[2]) if len(args) > 2 else False))
                elif mod == "SPPF":
                    layers.append(SPPF(c_in, c2, args[1]))
                elif mod == "PSA":
                    layers.append(PSA(c_in))
                else:
                    raise ValueError(f"unknown module {mod!r} in spec")
                c_in = c2
            chans.append(c_in)
        self.model = nn.ModuleList(layers)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)

    def logits(self, images: torch.Tensor):
        """images [B, 3, imgsz, imgsz] in [0, 1] → (box logits, class logits)."""
        ys: list = []
        x = images.to(self.dtype)
        for (frm, _n, mod, _args), layer in zip(self.spec, self.model):
            if mod == "Concat":
                x = torch.cat([ys[j] if j != -1 else x for j in frm], 1)
            elif mod == "Upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif mod == "Detect":
                return layer([ys[j] for j in frm])
            else:
                x = layer(x)
            ys.append(x)
        raise ValueError("the spec has no Detect layer")

    def forward(self, images: torch.Tensor, raw: bool = False):
        box_logits, cls_logits = self.logits(images)
        anchors, strides = _anchor_tensors(self.imgsz, str(box_logits.device))
        boxes = dfl_decode(box_logits, anchors, strides)
        scores = cls_logits.float().sigmoid()
        if raw:
            return boxes, scores
        return select_topk(boxes, scores, self.max_det)


def select_topk(boxes: torch.Tensor, scores: torch.Tensor, max_det: int):
    """v10's NMS-free selection: the top ``max_det`` anchors by their best
    class score, then the top ``max_det`` (anchor, class) pairs among them,
    each sorted by score. → (boxes [B, k, 4], scores [B, k], classes [B, k])."""
    nc = scores.shape[-1]
    k = min(max_det, scores.shape[1])
    idx = scores.amax(-1).topk(k, dim=-1).indices
    boxes_k = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
    scores_k = scores.gather(1, idx[..., None].expand(-1, -1, nc))
    flat, fidx = scores_k.flatten(1).topk(k, dim=-1)
    out_boxes = boxes_k.gather(1, (fidx // nc)[..., None].expand(-1, -1, 4))
    return out_boxes, flat, fidx % nc


def letterbox(img: np.ndarray, imgsz: int = 640,
              pad_value: int = 114) -> tuple[np.ndarray, float, tuple]:
    """Resize keeping aspect to (imgsz, imgsz) with gray padding
    (ultralytics LetterBox, centred). Returns (canvas, gain, (pad_x, pad_y))
    for mapping boxes back to source coordinates."""
    h, w = img.shape[:2]
    gain = min(imgsz / h, imgsz / w)
    nh, nw = round(h * gain), round(w * gain)
    try:
        import cv2

        resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    except ImportError:  # nearest fallback keeps the path dependency-free
        iy = (np.arange(nh) * h / nh).astype(np.int64).clip(0, h - 1)
        ix = (np.arange(nw) * w / nw).astype(np.int64).clip(0, w - 1)
        resized = img[iy][:, ix]
    canvas = np.full((imgsz, imgsz, 3), pad_value, img.dtype)
    top = (imgsz - nh) // 2
    left = (imgsz - nw) // 2
    canvas[top:top + nh, left:left + nw] = resized
    return canvas, gain, (left, top)


def build_yolo(state=None, *, scale: str = "x", nc: int = 80, imgsz: int = 640,
               max_det: int = 300, spec: tuple = YOLOV10_SPEC,
               dtype: torch.dtype = torch.float32, device=None, seed: int = 0) -> YoloV10:
    """A YoloV10 in eval mode on ``device``: ``state`` (the port's names,
    e.g. ``utils/yolo_convert.convert_yolo``'s output) checked key by key and
    shape by shape and taken as the module's tensors, so that models built
    from one device tree share its memory (a tensor not yet on ``device`` or
    in ``dtype`` is copied), or seeded random weights."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = YoloV10(scale, nc, imgsz, max_det, spec, dtype)
    if state is None:
        model.to_empty(device=device)
        random_init_(model, seed)
    else:
        from mere_fusion_tpu_torch.utils.yolo_convert import check_yolo_state

        check_yolo_state(state, model)
        model.load_state_dict(state, strict=True, assign=True)
        model.to(device)
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
    return model.eval()


class YoloDetector:
    """Host-side wrapper: letterbox → forward on the device → boxes in
    source pixel coordinates; the drop-in for the reference's
    ``model(image)`` + ``results[0].boxes`` (yolo_opencv.py:152-158).

    The frame goes to the device as uint8 and is normalised there."""

    def __init__(self, state=None, scale: str = "x", nc: int = 80, imgsz: int = 640,
                 max_det: int = 300, names: Sequence[str] = COCO_NAMES,
                 dtype: torch.dtype = torch.bfloat16, spec: tuple = YOLOV10_SPEC,
                 device=None, seed: int = 0, model: YoloV10 | None = None):
        self.device = resolve_device(device)
        with device_scope(self.device):
            self.model = model if model is not None else build_yolo(
                state, scale=scale, nc=nc, imgsz=imgsz, max_det=max_det, spec=spec,
                dtype=dtype, device=self.device, seed=seed)
        self.names = list(names)
        self.imgsz = self.model.imgsz

    @classmethod
    def init_random(cls, seed: int = 0, **kw) -> "YoloDetector":
        """Seeded random weights (random_init_), so the pipeline runs
        without a checkpoint."""
        return cls(None, seed=seed, **kw)

    @torch.no_grad()
    def detect(self, image_bgr: np.ndarray, conf: float = 0.25):
        """→ list of (xyxy np.ndarray[4], confidence, class_name)."""
        canvas, gain, (px, py) = letterbox(image_bgr, self.imgsz)
        rgb = np.ascontiguousarray(canvas[..., ::-1])
        with device_scope(self.device):
            x = torch.from_numpy(rgb).to(self.device).permute(2, 0, 1)[None]
            boxes, scores, classes = (t[0].cpu().numpy() for t in self.model(x.float() / 255.0))
        out = []
        h, w = image_bgr.shape[:2]
        for b, s, c in zip(boxes, scores, classes):
            if s < conf:
                break  # the top-k output is sorted descending
            xyxy = (b - np.array([px, py, px, py])) / gain
            xyxy = np.clip(xyxy, 0, [w, h, w, h]).astype(np.float32)
            out.append((xyxy, float(s), self.names[int(c)]))
        return out
