"""Standalone perception CLI, the reference's yolo_opencv.py file and stream
modes (yolo_opencv.py:22-38, 228-258): scene understanding over a video
file, an image directory or an RTP stream, one summary line per analysed
frame.

    python -m mere_fusion_tpu_torch.perception video.mp4 --backend yolo-tpu \\
        --ckpt yolov10x.pt --fpsthrottle 10

Port of mere_fusion_tpu/perception/__main__.py; ``yolo-tpu`` runs the port's
YOLOv10 on the card (``--device cpu`` on the CPU). RTP ingest needs the
ffmpeg binary (the reference pipes rtp → rawvideo the same way,
yolo_opencv.py:45-52); file and directory modes need cv2 to decode. Both
raise naming the dependency when it is missing.
"""
from __future__ import annotations

import argparse
import os


def iter_frames(source: str, framestart: int = 0, framelimit: int = 0):
    """Yield BGR uint8 frames from a video file, image dir, or rtp:// url."""
    if source.startswith("rtp://"):
        yield from _iter_rtp(source)
        return
    if os.path.isdir(source):
        try:
            import cv2
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("image-directory perception needs cv2 (opencv-python)") from e
        names = sorted(f for f in os.listdir(source)
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
        for i, name in enumerate(names):
            if i < framestart:
                continue
            if framelimit and i >= framestart + framelimit:
                return
            img = cv2.imread(os.path.join(source, name))
            if img is not None:
                yield img
        return
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("video-file perception needs cv2 (opencv-python)") from e
    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {source!r}")
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            if framelimit and i >= framestart + framelimit:
                return
            if i >= framestart:
                yield frame
            i += 1
    finally:
        cap.release()


def _iter_rtp(url: str):
    """RTP video ingest through an ffmpeg rawvideo pipe (reference
    yolo_opencv.py:45-52); raises naming ffmpeg when it is absent."""
    import shutil
    import subprocess

    import numpy as np

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "rtp:// perception ingest needs the ffmpeg binary "
            "(reference yolo_opencv.py:45-52 pipes rtp → rawvideo)")
    w, h = 1920, 1080  # the reference's fixed frame size (yolo_opencv.py:124-125)
    cmd = ["ffmpeg", "-protocol_whitelist", "file,udp,rtp", "-i", url,
           "-f", "image2pipe", "-pix_fmt", "bgr24", "-vcodec", "rawvideo", "-"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        n = w * h * 3
        while True:
            buf = proc.stdout.read(n)
            if len(buf) < n:
                return
            yield np.frombuffer(buf, np.uint8).reshape(h, w, 3).copy()
    finally:
        proc.terminate()
        proc.wait()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("mere-fusion-tpu-torch perception")
    p.add_argument("input", help="video file, image dir, or rtp://host:port")
    p.add_argument("--backend", default="yolo-tpu", choices=["stub", "yolo-tpu", "yolo"])
    p.add_argument("--ckpt", default="",
                   help="yolov10*.pt weights, or a converted dir (tools/convert_ckpt; "
                        "the JAX package's orbax dir needs tensorstore)")
    p.add_argument("--scale", default="x", choices=["n", "s", "m", "b", "l", "x"])
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("-fpt", "--fpsthrottle", type=int, default=10,
                   help="analyze every Nth frame (reference default 10)")
    p.add_argument("-fs", "--framestart", type=int, default=0)
    p.add_argument("-fl", "--framelimit", type=int, default=0,
                   help="frames to process (0 = all)")
    p.add_argument("--no-deepface", action="store_true")
    p.add_argument("--no-ocr", action="store_true")
    p.add_argument("--face-attrs", default="", dest="face_attrs",
                   help="face attributes on the card (yolo-tpu): 'random' or "
                        "'age=age.h5,gender=gender.h5,...'")
    p.add_argument("--ocr", default="",
                   help="scene-text OCR on the card (yolo-tpu): 'random' or "
                        "'craft=craft_mlt_25k.pth,crnn=english_g2.pth'")
    p.add_argument("--device", default="",
                   help="yolo-tpu's device (e.g. cpu); default: the current CUDA device")
    args = p.parse_args(argv)

    from mere_fusion_tpu_torch.perception import make_perception, parse_perception_spec

    kw: dict = {"fps_throttle": args.fpsthrottle}
    if args.backend in ("yolo-tpu", "yolo_tpu"):
        kw.update(ckpt=args.ckpt or None, scale=args.scale, conf=args.conf,
                  use_deepface=not args.no_deepface, use_ocr=not args.no_ocr,
                  face_attrs=parse_perception_spec(args.face_attrs),
                  ocr=parse_perception_spec(args.ocr), device=args.device or None)
    elif args.backend == "yolo":
        kw.update(use_deepface=not args.no_deepface, use_ocr=not args.no_ocr)
        if args.ckpt:
            kw["model_path"] = args.ckpt
    perception = make_perception(args.backend, **kw)

    for i, frame in enumerate(iter_frames(args.input, args.framestart, args.framelimit)):
        summary = perception.process_frame(frame)
        if summary:
            print(f"frame {args.framestart + i}: {summary}", flush=True)


if __name__ == "__main__":
    main()
