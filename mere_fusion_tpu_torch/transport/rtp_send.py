"""RTP output: a session's paced audio and video over plain UDP.

Port of mere_fusion_tpu/transport/rtp_send.py, the live leg that needs
neither ffmpeg nor aiortc:

- audio: L16 mono big-endian PCM (RFC 3551 §4.5.11) at 16 kHz, dynamic
  payload type 96, which ``transport.rtp.rtp_native_audio_chunks(
  l16_payload_type=96, l16_rate=16000)`` decodes;
- video: uncompressed RGB 8-bit per RFC 4175 (scan-line segments behind an
  extended sequence number), dynamic payload type 97, 90 kHz clock, the
  marker bit on a frame's last packet; ``rtp_native_video_frames`` here
  reassembles it;
- RTCP sender reports (RFC 3550 §6.4.1) every ~2 s on port + 1, so that a
  receiver can map RTP timestamps to wall-clock time.

Everything is stdlib and numpy. The packetizer runs in Python, once a
packet, on the caller's thread.
"""
from __future__ import annotations

import secrets
import socket
import struct
import time
from typing import Iterator, Optional

import numpy as np

from mere_fusion_tpu_torch.transport.rtp import parse_rtp_packet

L16_PAYLOAD_TYPE = 96
RAW_VIDEO_PAYLOAD_TYPE = 97
_MTU_PAYLOAD = 1380             # RTP payload budget under a 1500-byte MTU
_NTP_EPOCH_OFFSET = 2208988800  # 1900 → 1970


def _rtp_header(pt: int, seq: int, ts: int, ssrc: int, marker: bool) -> bytes:
    return struct.pack("!BBHII", 0x80, (pt & 0x7F) | (0x80 if marker else 0),
                       seq & 0xFFFF, ts & 0xFFFFFFFF, ssrc)


class _RtpStream:
    """Sequence and SSRC bookkeeping and RTCP sender reports of one stream."""

    def __init__(self, sock: socket.socket, addr, pt: int, clock_rate: int,
                 rtcp_addr=None):
        self.sock = sock
        self.addr = addr
        self.pt = pt
        self.clock_rate = clock_rate
        self.ssrc = secrets.randbits(32)
        # a 32-bit packet counter: the RTP header carries its low 16 bits and
        # an RFC 4175 payload its high 16 as the extended sequence number (a
        # counter of the stream, not of the frame: at 512² RGB and 25 fps the
        # 16-bit base wraps every ~5 s)
        self.seq = secrets.randbits(16)
        self.packets = 0
        self.octets = 0
        self.rtcp_addr = rtcp_addr
        self._last_sr = 0.0

    @property
    def ext_seq(self) -> int:
        """High 16 bits of the next packet's 32-bit sequence number."""
        return (self.seq >> 16) & 0xFFFF

    def send(self, payload: bytes, ts: int, marker: bool) -> None:
        self.sock.sendto(_rtp_header(self.pt, self.seq, ts, self.ssrc, marker) + payload,
                         self.addr)
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        self.packets += 1
        self.octets += len(payload)

    def maybe_send_sr(self, ts: int, interval: float = 2.0) -> None:
        if self.rtcp_addr is None:
            return
        now = time.time()
        if now - self._last_sr < interval:
            return
        self._last_sr = now
        ntp = now + _NTP_EPOCH_OFFSET
        ntp_sec = int(ntp)
        ntp_frac = int((ntp - ntp_sec) * (1 << 32)) & 0xFFFFFFFF
        # SR: V=2, P=0, RC=0, PT=200, length = 6 words after the first
        pkt = struct.pack("!BBHIIIIII", 0x80, 200, 6, self.ssrc,
                          ntp_sec & 0xFFFFFFFF, ntp_frac, ts & 0xFFFFFFFF,
                          self.packets & 0xFFFFFFFF, self.octets & 0xFFFFFFFF)
        self.sock.sendto(pkt, self.rtcp_addr)


def _rfc4175_segments(h: int, w: int, line: int, offset_px: int):
    """The line segments of the next packet from (line, offset_px): a list of
    (line, pixel offset, bytes), packed greedily under the payload budget
    (2 bytes of extended sequence, 6 of header and the pixels a segment),
    and the (line, offset_px) after them."""
    segments = []
    room = _MTU_PAYLOAD - 2
    while line < h and room >= 6 + 3:
        take_px = min(w - offset_px, (room - 6) // 3)
        if take_px <= 0:
            break
        segments.append((line, offset_px, take_px * 3))
        room -= 6 + take_px * 3
        offset_px += take_px
        if offset_px >= w:
            line, offset_px = line + 1, 0
    return segments, line, offset_px


class RtpSender:
    """Send paced engine frames as RTP over UDP: L16 audio, RFC 4175 video."""

    def __init__(self, host: str = "127.0.0.1", audio_port: int = 5004,
                 video_port: int = 5006, rtcp: bool = True):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.audio = _RtpStream(self.sock, (host, audio_port), L16_PAYLOAD_TYPE, 16000,
                                rtcp_addr=(host, audio_port + 1) if rtcp else None)
        self.video = _RtpStream(self.sock, (host, video_port), RAW_VIDEO_PAYLOAD_TYPE, 90000,
                                rtcp_addr=(host, video_port + 1) if rtcp else None)

    def send_audio(self, samples: np.ndarray, ts: int) -> None:
        """samples: int16 mono (one 20 ms chunk); ts in samples at 16 kHz."""
        self.audio.send(samples.astype(">i2").tobytes(), ts, marker=False)
        self.audio.maybe_send_sr(ts)

    def send_video(self, image_bgr: np.ndarray, ts: int) -> None:
        """image_bgr: [H, W, 3] uint8 (the engines' order), sent as RGB
        scan-line segments with the marker on the frame's last packet."""
        h, w = image_bgr.shape[:2]
        rows = np.ascontiguousarray(image_bgr[..., ::-1]).reshape(h, w * 3)
        line = offset_px = 0
        while line < h:
            segments, line, offset_px = _rfc4175_segments(h, w, line, offset_px)
            payload = bytearray(struct.pack("!H", self.video.ext_seq))
            for i, (ln, off, nbytes) in enumerate(segments):
                cont = 0x8000 if i + 1 < len(segments) else 0
                payload += struct.pack("!HHH", nbytes, ln & 0x7FFF, cont | (off & 0x7FFF))
            for ln, off, nbytes in segments:
                payload += rows[ln, off * 3 : off * 3 + nbytes].tobytes()
            self.video.send(bytes(payload), ts, marker=line >= h)
        self.video.maybe_send_sr(ts)

    def close(self) -> None:
        self.sock.close()


class RtpTrackSink:
    """Drain a session's paced tracks into an RtpSender (the rtp counterpart
    of transport.rtmp.RtmpTrackSink). Frames keep their track pts as the RTP
    timestamp."""

    def __init__(self, sender: RtpSender):
        self.sender = sender
        self._audio_ts = 0
        self._video_ts = 0

    async def run(self, video_track, audio_track, quit_event) -> None:
        import asyncio

        async def pump_video():
            while not quit_event.is_set():
                frame = await video_track.recv()
                ts = frame.pts if frame.pts is not None else self._video_ts
                self.sender.send_video(frame.image, ts)
                self._video_ts = ts + 90000 // 25

        async def pump_audio():
            while not quit_event.is_set():
                chunk = await audio_track.recv()
                ts = chunk.pts if chunk.pts is not None else self._audio_ts
                self.sender.send_audio(chunk.samples, ts)
                self._audio_ts = ts + chunk.samples.shape[0]

        await asyncio.gather(pump_video(), pump_audio())


# ---- receive side -------------------------------------------------------------

def parse_rfc4175_packet(payload: bytes):
    """RFC 4175 payload → [(line, pixel offset, data bytes)]."""
    if len(payload) < 2:
        return []
    pos = 2   # the extended sequence number
    headers = []
    while pos + 6 <= len(payload):
        nbytes, ln, off = struct.unpack("!HHH", payload[pos : pos + 6])
        pos += 6
        headers.append((nbytes, ln & 0x7FFF, off & 0x7FFF))
        if not off & 0x8000:
            break
    segments = []
    for nbytes, ln, off in headers:
        segments.append((ln, off, payload[pos : pos + nbytes]))
        pos += nbytes
    return segments


def rtp_native_video_frames(bind=("0.0.0.0", 5006), width: int = 512, height: int = 512,
                            payload_type: int = RAW_VIDEO_PAYLOAD_TYPE,
                            sock: Optional[socket.socket] = None,
                            timeout: Optional[float] = 30.0) -> Iterator[np.ndarray]:
    """Reassemble RFC 4175 RGB frames from UDP into BGR uint8 [H, W, 3],
    until ``timeout`` seconds pass with no datagram.

    Frames are keyed by RTP timestamp and yielded on the marker bit; packets
    of an older timestamp (a late reorder across a frame boundary) are
    dropped."""
    own = sock is None
    if own:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(bind)
    if timeout is not None:
        sock.settimeout(timeout)
    cur_ts = None
    yielded = False
    frame = np.zeros((height, width * 3), np.uint8)
    try:
        while True:
            try:
                data, _addr = sock.recvfrom(65536)
            except socket.timeout:
                break
            parsed = parse_rtp_packet(data)
            if parsed is None:
                continue
            pt, _seq, ts, payload = parsed
            if pt != payload_type:
                continue
            if ts != cur_ts:
                if cur_ts is not None and ((ts - cur_ts) & 0xFFFFFFFF) >= 0x80000000:
                    continue   # a late packet of a finished frame
                cur_ts = ts
                yielded = False
                frame[:] = 0
            elif yielded:
                continue       # a duplicate tail of a yielded frame
            for ln, off_px, seg in parse_rfc4175_packet(payload):
                if ln >= height:
                    continue
                start = off_px * 3
                end = min(start + len(seg), width * 3)
                frame[ln, start:end] = np.frombuffer(seg[: end - start], np.uint8)
            if data[1] & 0x80:   # marker: the frame is complete
                yield np.ascontiguousarray(frame.reshape(height, width, 3)[..., ::-1])
                yielded = True
    finally:
        if own:
            sock.close()
