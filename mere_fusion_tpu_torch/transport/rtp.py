"""RTP/RTSP media ingest.

Port of mere_fusion_tpu/transport/rtp.py (reference:
whisper_online_server.py:194-206 for audio, yolo_opencv.py:45-52 for video).
Two audio ingest paths:

- ``rtp_audio_chunks`` and ``rtp_video_frames`` pipe the stream through an
  ``ffmpeg`` process (any codec ffmpeg can demux; needs the binary);
- ``rtp_native_audio_chunks`` is a UDP receiver with its own RTP
  depacketizer and G.711 µ-law/A-law/L16 decoders: numpy, ``struct`` and
  sockets only.
"""
from __future__ import annotations

import socket
import struct
import subprocess
from typing import Iterator, Optional

import numpy as np


def rtp_audio_chunks(url: str, sample_rate: int = 16000,
                     chunk_seconds: float = 1.0,
                     sdp_file: str | None = None) -> Iterator[np.ndarray]:
    """Yield float32 PCM chunks from an RTP/RTSP/RTMP source through ffmpeg."""
    src = (["-protocol_whitelist", "file,udp,rtp", "-i", sdp_file] if sdp_file
           else ["-i", url])
    cmd = ["ffmpeg", "-loglevel", "error", *src,
           "-vn", "-acodec", "pcm_s16le", "-ac", "1", "-ar", str(sample_rate),
           "-f", "s16le", "pipe:1"]
    n_bytes = int(chunk_seconds * sample_rate) * 2
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    try:
        while True:
            data = proc.stdout.read(n_bytes)
            if not data:
                break
            yield np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    finally:
        proc.kill()


# ---- RTP (RFC 3550 header) and G.711 / L16 payloads --------------------------

def parse_rtp_packet(data: bytes):
    """(payload_type, sequence, timestamp, payload), or None for a datagram
    that is not RTP. Skips the CSRC list and a header extension and strips
    padding (RFC 3550 §5.1)."""
    if len(data) < 12:
        return None
    b0, b1, seq, ts, _ssrc = struct.unpack("!BBHII", data[:12])
    if b0 >> 6 != 2:                        # version
        return None
    offset = 12 + 4 * (b0 & 0x0F)           # CSRC count
    if b0 & 0x10:                           # header extension
        if len(data) < offset + 4:
            return None
        offset += 4 + 4 * struct.unpack("!H", data[offset + 2 : offset + 4])[0]
    end = len(data)
    if b0 & 0x20 and end > offset:          # padding: the last byte counts it
        end -= data[-1]
    if end < offset:
        return None
    return b1 & 0x7F, seq, ts, data[offset:end]


def ulaw_decode(payload: bytes) -> np.ndarray:
    """G.711 µ-law → int16 (ITU-T G.711, as audioop.ulaw2lin)."""
    u = ~np.frombuffer(payload, np.uint8) & 0xFF
    exp = (u >> 4) & 0x07
    mant = (u & 0x0F).astype(np.int32)
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(u & 0x80, -mag, mag).astype(np.int16)


def alaw_decode(payload: bytes) -> np.ndarray:
    """G.711 A-law → int16 (ITU-T G.711, as audioop.alaw2lin)."""
    a = np.frombuffer(payload, np.uint8) ^ 0x55
    exp = (a >> 4) & 0x07
    mant = (a & 0x0F).astype(np.int32)
    mag = np.where(exp > 0, ((mant << 4) + 0x108) << (exp - 1), (mant << 4) + 8)
    return np.where(a & 0x80, mag, -mag).astype(np.int16)


_G711_RATE = 8000
_DECODERS = {0: ulaw_decode, 8: alaw_decode}


def _l16(payload: bytes) -> np.ndarray:
    n = len(payload) // 2 * 2
    return np.frombuffer(payload[:n], ">i2").astype(np.int16)


def decode_rtp_audio(pt: int, payload: bytes,
                     l16_payload_type: Optional[int] = None,
                     l16_rate: int = 16000) -> Optional[tuple[np.ndarray, int]]:
    """(int16 samples, sample rate) of a supported payload type: 0 PCMU and
    8 PCMA at 8 kHz, 11 L16 mono at 44.1 kHz (RFC 3551), and
    ``l16_payload_type``, a negotiated L16 mono at ``l16_rate``; else None."""
    if pt in _DECODERS:
        return _DECODERS[pt](payload), _G711_RATE
    if pt == 11:
        return _l16(payload), 44100
    if l16_payload_type is not None and pt == l16_payload_type:
        return _l16(payload), l16_rate
    return None


def rtp_native_audio_chunks(bind=("0.0.0.0", 5004), sample_rate: int = 16000,
                            chunk_seconds: float = 1.0,
                            l16_payload_type: Optional[int] = None,
                            l16_rate: int = 16000,
                            sock: Optional[socket.socket] = None,
                            timeout: Optional[float] = 30.0) -> Iterator[np.ndarray]:
    """Yield float32 PCM chunks at ``sample_rate`` from a live RTP/UDP feed,
    without ffmpeg, until ``timeout`` seconds pass with no datagram.

    Packets are decoded in arrival order; duplicates and packets stale by
    sequence are dropped. ``sock`` is a bound UDP socket to read instead of
    binding ``bind`` (the caller keeps it open)."""
    from mere_fusion_tpu_torch.tts import resample_pcm

    own = sock is None
    if own:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(bind)
    if timeout is not None:
        sock.settimeout(timeout)
    target = int(chunk_seconds * sample_rate)
    buf: list[np.ndarray] = []
    buffered = 0
    last_seq = None
    try:
        while True:
            try:
                data, _addr = sock.recvfrom(65536)
            except socket.timeout:
                break
            if not data:
                continue   # an empty datagram is a NAT keepalive, not the end
            parsed = parse_rtp_packet(data)
            if parsed is None:
                continue
            pt, seq, _ts, payload = parsed
            if last_seq is not None:
                ahead = (seq - last_seq) & 0xFFFF
                if ahead == 0 or ahead > 0x8000:   # duplicate or late
                    continue
            last_seq = seq
            decoded = decode_rtp_audio(pt, payload, l16_payload_type, l16_rate)
            if decoded is None:
                continue
            samples, rate = decoded
            pcm = samples.astype(np.float32) / 32768.0
            if rate != sample_rate:
                pcm = resample_pcm(pcm, rate, sample_rate)
            buf.append(pcm)
            buffered += len(pcm)
            if buffered >= target:
                out = np.concatenate(buf)
                buf, buffered = [out[target:]], len(out) - target
                yield out[:target]
    finally:
        if own:
            sock.close()
    if buffered:
        yield np.concatenate(buf)


def rtp_video_frames(url: str, width: int, height: int) -> Iterator[np.ndarray]:
    """Yield BGR uint8 frames from an RTP/RTSP/RTMP source through ffmpeg."""
    cmd = ["ffmpeg", "-loglevel", "error", "-i", url,
           "-an", "-f", "rawvideo", "-pix_fmt", "bgr24",
           "-s", f"{width}x{height}", "pipe:1"]
    n_bytes = width * height * 3
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
    try:
        while True:
            data = proc.stdout.read(n_bytes)
            if len(data) < n_bytes:
                break
            yield np.frombuffer(data, np.uint8).reshape(height, width, 3)
    finally:
        proc.kill()
