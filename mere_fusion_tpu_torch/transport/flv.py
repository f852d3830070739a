"""FLV muxing in Python: Screen Video v1 and PCM16LE audio.

Port of mere_fusion_tpu/transport/flv.py, for RTMP push and recording when
ffmpeg is absent. The codecs are ones Python can encode and stock players
decode:

- video: FLV codec 3, "Screen Video" v1: the frame is cut into square
  blocks, each zlib-deflated raw BGR, scanned bottom-up. A keyframe carries
  every block; an interframe only the blocks that changed since the
  previous frame (a zero-length block means "reuse").
- audio: FLV sound format 3 (linear PCM, little-endian), 16-bit mono.

The tag and body layouts follow the Adobe FLV/F4V spec v10.1.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

FLV_HEADER = b"FLV\x01\x05\x00\x00\x00\x09"  # version 1, audio and video

TAG_AUDIO = 8
TAG_VIDEO = 9
TAG_SCRIPT = 18

_BLOCK = 64  # Screen Video block edge (16..256, a multiple of 16)


# ---- AMF0 (what FLV metadata and RTMP commands use) --------------------------

def amf0_encode(value) -> bytes:
    if value is None:
        return b"\x05"
    if isinstance(value, bool):
        return b"\x01" + (b"\x01" if value else b"\x00")
    if isinstance(value, (int, float)):
        return b"\x00" + struct.pack(">d", float(value))
    if isinstance(value, str):
        raw = value.encode()
        return b"\x02" + struct.pack(">H", len(raw)) + raw
    if isinstance(value, dict):
        out = [b"\x03"]
        for k, v in value.items():
            raw = k.encode()
            out += [struct.pack(">H", len(raw)), raw, amf0_encode(v)]
        return b"".join(out) + b"\x00\x00\x09"
    if isinstance(value, (list, tuple)):   # strict array
        return (b"\x0a" + struct.pack(">I", len(value))
                + b"".join(amf0_encode(v) for v in value))
    raise TypeError(f"AMF0 cannot encode {type(value)!r}")


def amf0_decode(data: bytes, offset: int = 0):
    """(value, next offset) of the AMF0 value at ``offset``."""
    marker = data[offset]
    offset += 1
    if marker == 0x00:
        return struct.unpack(">d", data[offset : offset + 8])[0], offset + 8
    if marker == 0x01:
        return bool(data[offset]), offset + 1
    if marker == 0x02:
        n = struct.unpack(">H", data[offset : offset + 2])[0]
        return data[offset + 2 : offset + 2 + n].decode(), offset + 2 + n
    if marker in (0x03, 0x08):   # object, ECMA array
        if marker == 0x08:
            offset += 4          # the approximate length, unused
        obj = {}
        while True:
            n = struct.unpack(">H", data[offset : offset + 2])[0]
            offset += 2
            if n == 0 and data[offset] == 0x09:
                return obj, offset + 1
            key = data[offset : offset + n].decode()
            obj[key], offset = amf0_decode(data, offset + n)
    if marker in (0x05, 0x06):   # null, undefined
        return None, offset
    if marker == 0x0A:
        n = struct.unpack(">I", data[offset : offset + 4])[0]
        offset += 4
        arr = []
        for _ in range(n):
            v, offset = amf0_decode(data, offset)
            arr.append(v)
        return arr, offset
    raise ValueError(f"AMF0 marker {marker:#x} unsupported")


# ---- Screen Video v1 ------------------------------------------------------------

def encode_screen_video(frame_bgr: np.ndarray, prev_bgr: Optional[np.ndarray] = None,
                        block: int = _BLOCK) -> bytes:
    """One Screen Video v1 frame body (after the FLV frame-type byte): a
    keyframe when ``prev_bgr`` is None, else an interframe whose blocks equal
    to the previous frame's are written with zero length."""
    h, w = frame_bgr.shape[:2]
    code = (block // 16 - 1) << 12
    out = [struct.pack(">HH", code | w, code | h)]
    cur = frame_bgr[::-1]   # Screen Video scans bottom-up
    prev = prev_bgr[::-1] if prev_bgr is not None else None
    for by in range(0, h, block):
        for bx in range(0, w, block):
            blk = cur[by : by + block, bx : bx + block]
            if prev is not None and np.array_equal(blk, prev[by : by + block, bx : bx + block]):
                out.append(b"\x00\x00")
                continue
            raw = zlib.compress(np.ascontiguousarray(blk).tobytes(), 6)
            out.append(struct.pack(">H", len(raw)) + raw)
    return b"".join(out)


def decode_screen_video(body: bytes, prev_bgr: Optional[np.ndarray] = None) -> np.ndarray:
    """Inverse of encode_screen_video: the BGR frame of one body, the blocks
    it skips taken from ``prev_bgr``."""
    bw_w, bh_h = struct.unpack(">HH", body[:4])
    block_w, block_h = ((bw_w >> 12) + 1) * 16, ((bh_h >> 12) + 1) * 16
    w, h = bw_w & 0x0FFF, bh_h & 0x0FFF
    img = prev_bgr[::-1].copy() if prev_bgr is not None else np.zeros((h, w, 3), np.uint8)
    offset = 4
    for by in range(0, h, block_h):
        for bx in range(0, w, block_w):
            n = struct.unpack(">H", body[offset : offset + 2])[0]
            offset += 2
            if n == 0:
                continue
            raw = zlib.decompress(body[offset : offset + n])
            offset += n
            bh, bw = min(block_h, h - by), min(block_w, w - bx)
            img[by : by + bh, bx : bx + bw] = np.frombuffer(raw, np.uint8).reshape(bh, bw, 3)
    return img[::-1]


# ---- FLV tags ----------------------------------------------------------------------

def flv_tag(tag_type: int, timestamp_ms: int, body: bytes) -> bytes:
    """One FLV tag: the 11-byte header (24-bit size and timestamp, its
    extension byte, stream id 0), the body and the previous-tag-size word."""
    ts = int(timestamp_ms) & 0xFFFFFFFF
    n = len(body)
    head = bytes([tag_type, (n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF,
                  (ts >> 16) & 0xFF, (ts >> 8) & 0xFF, ts & 0xFF, (ts >> 24) & 0xFF,
                  0, 0, 0])
    return head + body + struct.pack(">I", 11 + n)


class FlvPacketizer:
    """Paced frames and PCM → (tag type, timestamp ms, FLV body): the codec
    and timing state that FLVWriter (files) and the RTMP publisher (sockets)
    share."""

    # sound format 3 = PCM LE; rate bits 0=5.5k 1=11k 2=22k 3=44k: FLV has no
    # 16 kHz code, so players read the rate from onMetaData; 16-bit mono
    AUDIO_HEADER = bytes([(3 << 4) | (1 << 2) | (1 << 1) | 0])

    def __init__(self, width: int, height: int, fps: int = 25,
                 sample_rate: int = 16000, gop: int = 50):
        self.width, self.height = width, height
        self.fps = fps
        self.sample_rate = sample_rate
        self.gop = gop
        self._n_video = 0
        self._audio_ms = 0.0
        self._prev = None

    def metadata(self) -> dict:
        return {"width": self.width, "height": self.height, "framerate": self.fps,
                "videocodecid": 3, "audiocodecid": 3,
                "audiosamplerate": self.sample_rate, "audiosamplesize": 16,
                "stereo": False, "encoder": "mere-fusion-tpu"}

    def video_tag(self, frame_bgr: np.ndarray) -> tuple[int, int, bytes]:
        key = self._prev is None or self._n_video % self.gop == 0
        body = encode_screen_video(frame_bgr, None if key else self._prev)
        ts = int(self._n_video * 1000 / self.fps)
        self._prev = frame_bgr.copy()
        self._n_video += 1
        return TAG_VIDEO, ts, bytes([((1 if key else 2) << 4) | 3]) + body

    def audio_tag(self, pcm_f32: np.ndarray) -> tuple[int, int, bytes]:
        pcm16 = (np.clip(pcm_f32, -1.0, 1.0) * 32767).astype("<i2")
        ts = int(self._audio_ms)
        self._audio_ms += len(pcm16) * 1000.0 / self.sample_rate
        return TAG_AUDIO, ts, self.AUDIO_HEADER + pcm16.tobytes()


class FLVWriter:
    """Mux paced video frames and PCM chunks into an .flv file object:
    Screen Video with a keyframe every ``gop`` frames, PCM16LE mono."""

    def __init__(self, fileobj, width: int, height: int, fps: int = 25,
                 sample_rate: int = 16000, gop: int = 50):
        self._f = fileobj
        self._pkt = FlvPacketizer(width, height, fps, sample_rate, gop)
        self._f.write(FLV_HEADER + b"\x00\x00\x00\x00")   # PreviousTagSize0
        meta = amf0_encode("onMetaData") + amf0_encode(self._pkt.metadata())
        self._f.write(flv_tag(TAG_SCRIPT, 0, meta))

    def write_video(self, frame_bgr: np.ndarray) -> None:
        self._f.write(flv_tag(*self._pkt.video_tag(frame_bgr)))

    def write_audio(self, pcm_f32: np.ndarray) -> None:
        self._f.write(flv_tag(*self._pkt.audio_tag(pcm_f32)))

    def close(self) -> None:
        self._f.flush()


def read_flv_tags(data: bytes) -> list[tuple[int, int, bytes]]:
    """Parse an FLV byte stream into (tag type, timestamp ms, body)."""
    if data[:3] != b"FLV":
        raise ValueError("not an FLV stream")
    offset = struct.unpack(">I", data[5:9])[0] + 4   # header + PreviousTagSize0
    tags = []
    while offset + 11 <= len(data):
        size = int.from_bytes(data[offset + 1 : offset + 4], "big")
        ts = int.from_bytes(data[offset + 4 : offset + 7], "big") | (data[offset + 7] << 24)
        tags.append((data[offset], ts, data[offset + 11 : offset + 11 + size]))
        offset += 11 + size + 4
    return tags
