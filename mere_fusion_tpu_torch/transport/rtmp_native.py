"""RTMP publishing client in Python (no ffmpeg, no librtmp).

Port of mere_fusion_tpu/transport/rtmp_native.py: what a publisher needs of
RTMP. The plain handshake; a chunk reader and writer (fmt 0-3 headers,
extended timestamps, the peer's chunk-size changes); the AMF0 commands
connect → createStream → publish; ping replies and window acknowledgements;
audio, video and metadata messages. ``transport.rtmp.RtmpStreamer`` uses it
when ffmpeg is absent, with Screen Video v1 and PCM16LE from
``transport.flv``.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
import urllib.parse

from mere_fusion_tpu_torch.transport.flv import amf0_decode, amf0_encode

MSG_SET_CHUNK_SIZE = 1
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

_OUT_CHUNK = 4096


class RtmpError(RuntimeError):
    pass


def parse_rtmp_url(url: str):
    """rtmp://host[:port]/app[/...]/stream → (host, port, app, stream)."""
    u = urllib.parse.urlparse(url)
    if u.scheme != "rtmp":
        raise RtmpError(f"not an rtmp url: {url}")
    parts = [p for p in u.path.split("/") if p]
    if len(parts) < 2:
        raise RtmpError(f"rtmp url needs /app/stream: {url}")
    return u.hostname, u.port or 1935, "/".join(parts[:-1]), parts[-1]


def _new_chunk_stream() -> dict:
    return {"ts": 0, "len": 0, "type": 0, "msid": 0, "delta": 0, "ext": False}


class _ChunkReader:
    """Assembles RTMP messages from a socket, keeping each chunk stream's
    last header."""

    def __init__(self, sock, stop_check=None):
        self._sock = sock
        self._chunk_size = 128
        self._streams: dict[int, dict] = {}
        self._pending: dict[int, bytearray] = {}
        self.bytes_read = 0
        # asked on a socket timeout: True aborts; otherwise the read goes on
        # waiting and keeps what it has (giving up inside a message would
        # desynchronise the chunk stream for good)
        self.stop_check = stop_check

    def _recv(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            try:
                part = self._sock.recv(n - len(buf))
            except socket.timeout:
                if self.stop_check is not None and self.stop_check():
                    raise RtmpError("receive aborted") from None
                continue
            if not part:
                raise RtmpError("connection closed by peer")
            buf += part
        self.bytes_read += n
        return buf

    def _read_ts(self, st: dict, field: int) -> int:
        """A 24-bit timestamp field, or the 32-bit extended one after it."""
        st["ext"] = field == 0xFFFFFF
        return int.from_bytes(self._recv(4), "big") if st["ext"] else field

    def read_message(self):
        """(message type, message stream id, payload) of one whole message."""
        while True:
            b0 = self._recv(1)[0]
            fmt, csid = b0 >> 6, b0 & 0x3F
            if csid == 0:
                csid = 64 + self._recv(1)[0]
            elif csid == 1:
                ext = self._recv(2)
                csid = 64 + ext[0] + ext[1] * 256
            st = self._streams.setdefault(csid, _new_chunk_stream())
            if fmt == 0:
                h = self._recv(11)
                st["len"] = int.from_bytes(h[3:6], "big")
                st["type"] = h[6]
                st["msid"] = int.from_bytes(h[7:11], "little")
                st["delta"] = 0
                st["ts"] = self._read_ts(st, int.from_bytes(h[0:3], "big"))
            elif fmt == 1:
                h = self._recv(7)
                st["len"] = int.from_bytes(h[3:6], "big")
                st["type"] = h[6]
                st["delta"] = self._read_ts(st, int.from_bytes(h[0:3], "big"))
                st["ts"] += st["delta"]
            elif fmt == 2:
                st["delta"] = self._read_ts(st, int.from_bytes(self._recv(3), "big"))
                st["ts"] += st["delta"]
            else:   # fmt 3: a continuation, or the last header repeated; an
                # extended-timestamp chunk stream repeats its 4 bytes here
                if st["ext"]:
                    self._recv(4)
                if csid not in self._pending:
                    st["ts"] += st["delta"]
            buf = self._pending.setdefault(csid, bytearray())
            buf += self._recv(min(self._chunk_size, st["len"] - len(buf)))
            if len(buf) >= st["len"]:
                payload = bytes(self._pending.pop(csid))
                if st["type"] == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
                    self._chunk_size = struct.unpack(">I", payload[:4])[0]
                    continue
                return st["type"], st["msid"], payload


def decode_amf0_values(payload: bytes) -> list:
    """Every AMF0 value of a command or data message, in order."""
    vals, offset = [], 0
    while offset < len(payload):
        v, offset = amf0_decode(payload, offset)
        vals.append(v)
    return vals


class RtmpPublisher:
    """Connect and publish a stream, then send FLV audio and video bodies."""

    def __init__(self, url: str, timeout: float = 10.0, sock=None):
        host, port, app, stream = parse_rtmp_url(url)
        self.stream_name = stream
        self._sock = sock or socket.create_connection((host, port), timeout)
        self._sock.settimeout(timeout)
        self._setup_deadline = time.monotonic() + max(timeout, 10.0)
        self._reader = _ChunkReader(
            self._sock,
            stop_check=lambda: self._closed or (
                self._setup_deadline is not None and time.monotonic() > self._setup_deadline))
        self._txn = 0
        self._window = 2_500_000
        self._acked = 0
        self._msid = 0
        self._send_lock = threading.Lock()
        self._closed = False
        self._handshake()
        self._send_message(2, MSG_SET_CHUNK_SIZE, 0, struct.pack(">I", _OUT_CHUNK))
        self._connect(app, f"rtmp://{host}:{port}/{app}")
        self._msid = self._create_stream()
        self._publish(stream)
        self._setup_deadline = None   # steady state: wait patiently
        # a long publish must keep reading the server's pings, acks and
        # onStatus messages: unread ones fill the socket buffer, and servers
        # that enforce pings drop the stream
        threading.Thread(target=self._reader_loop, daemon=True).start()

    def _reader_loop(self) -> None:
        try:
            while not self._closed:
                msg_type, _msid, payload = self._reader.read_message()
                self._service(msg_type, payload)
        except (RtmpError, OSError):
            pass   # the connection ended; the senders raise it

    # ---- wire -------------------------------------------------------------------
    def _handshake(self) -> None:
        c1 = struct.pack(">II", int(time.time()) & 0x7FFFFFFF, 0) + os.urandom(1528)
        self._sock.sendall(b"\x03" + c1)
        s0 = self._reader._recv(1)
        if s0 != b"\x03":
            raise RtmpError(f"unsupported RTMP version {s0!r}")
        s1 = self._reader._recv(1536)
        self._reader._recv(1536)    # s2
        self._sock.sendall(s1)      # c2 echoes s1
        self._reader.bytes_read = 0

    def _send_message(self, csid: int, msg_type: int, msid: int, payload: bytes,
                      timestamp: int = 0) -> None:
        ts = int(timestamp) & 0xFFFFFFFF
        ext = ts >= 0xFFFFFF   # the extended timestamp (spec §5.3.1.3)
        ext_bytes = struct.pack(">I", ts) if ext else b""
        header = (bytes([csid & 0x3F]) + (0xFFFFFF if ext else ts).to_bytes(3, "big")
                  + len(payload).to_bytes(3, "big") + bytes([msg_type])
                  + msid.to_bytes(4, "little") + ext_bytes)
        # continuation chunks repeat an extended timestamp after their fmt-3
        # basic header
        cont = bytes([0xC0 | (csid & 0x3F)]) + ext_bytes
        out = bytearray()
        for i in range(0, len(payload), _OUT_CHUNK):
            out += header if i == 0 else cont
            out += payload[i : i + _OUT_CHUNK]
        with self._send_lock:
            self._sock.sendall(bytes(out))

    def _command(self, name: str, *args, csid: int = 3, msid: int = 0) -> int:
        self._txn += 1
        body = amf0_encode(name) + amf0_encode(self._txn) + b"".join(amf0_encode(a) for a in args)
        self._send_message(csid, MSG_COMMAND_AMF0, msid, body)
        return self._txn

    def _service(self, msg_type: int, payload: bytes) -> None:
        """Housekeeping for the messages that are not commands."""
        if msg_type == MSG_WINDOW_ACK_SIZE and len(payload) >= 4:
            self._window = struct.unpack(">I", payload[:4])[0]
        elif msg_type == MSG_USER_CONTROL and len(payload) >= 2:
            if struct.unpack(">H", payload[:2])[0] == 6:   # PingRequest → PingResponse
                self._send_message(2, MSG_USER_CONTROL, 0, struct.pack(">H", 7) + payload[2:6])
        if self._reader.bytes_read - self._acked >= self._window // 2:
            self._acked = self._reader.bytes_read
            self._send_message(2, MSG_ACK, 0, struct.pack(">I", self._acked))

    def _await_command(self, accept) -> list:
        """Read until an AMF0 command that ``accept(name, values)`` takes;
        its decoded values."""
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            msg_type, _msid, payload = self._reader.read_message()
            if msg_type != MSG_COMMAND_AMF0:
                self._service(msg_type, payload)
                continue
            vals = decode_amf0_values(payload)
            name = vals[0] if vals else ""
            if name == "_error":
                raise RtmpError(f"server rejected command: {vals}")
            if accept(name, vals):
                return vals
        raise RtmpError("timed out waiting for server response")

    # ---- session -------------------------------------------------------------
    def _connect(self, app: str, tc_url: str) -> None:
        txn = self._command("connect", {"app": app, "type": "nonprivate",
                                        "flashVer": "FMLE/3.0", "tcUrl": tc_url})
        self._await_command(lambda name, vals: name == "_result" and vals[1] == txn)

    def _create_stream(self) -> int:
        txn = self._command("createStream", None)
        vals = self._await_command(lambda name, vals: name == "_result" and vals[1] == txn)
        return int(vals[3])

    def _publish(self, stream: str) -> None:
        self._command("publish", None, stream, "live", csid=3, msid=self._msid)
        self._await_command(lambda name, vals: name == "onStatus" and any(
            isinstance(v, dict) and v.get("code") == "NetStream.Publish.Start" for v in vals))

    # ---- media ------------------------------------------------------------------
    def send_metadata(self, meta: dict) -> None:
        """@setDataFrame/onMetaData (an AMF0 data message)."""
        body = amf0_encode("@setDataFrame") + amf0_encode("onMetaData") + amf0_encode(meta)
        self._send_message(4, MSG_DATA_AMF0, self._msid, body)

    def send_video(self, flv_video_body: bytes, timestamp_ms: int) -> None:
        self._send_message(4, MSG_VIDEO, self._msid, flv_video_body, timestamp=int(timestamp_ms))

    def send_audio(self, flv_audio_body: bytes, timestamp_ms: int) -> None:
        self._send_message(4, MSG_AUDIO, self._msid, flv_audio_body, timestamp=int(timestamp_ms))

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
