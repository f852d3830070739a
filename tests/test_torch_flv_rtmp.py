"""The port's FLV muxer and RTMP publishing against the JAX package's:
transport/flv.py, transport/rtmp_native.py and transport/rtmp.py.

Twins of tests/test_flv_rtmp_native.py (test_engine_flv_recording's is in
tests/test_torch_recording.py) and of the ffmpeg-piped streamer test of
tests/test_misc_transport.py, then byte parity with the JAX package (Screen
Video key and inter frames, AMF0, FLV tags and an FLVWriter file, the RTMP
chunk writer) and its readers and writers across the packages. The mini
RTMP server is a real TCP peer: it shakes hands, reads the client's chunk
stream with either package's reader, answers connect / createStream /
publish and keeps the media messages.
"""
from __future__ import annotations

import io
import socket
import stat
import struct
import sys
import threading

import numpy as np
import pytest

from mere_fusion_tpu.transport import flv as jax_flv
from mere_fusion_tpu.transport import rtmp_native as jax_native
from mere_fusion_tpu_torch.transport import flv, rtmp_native
from mere_fusion_tpu_torch.transport.flv import (
    FLVWriter,
    amf0_decode,
    amf0_encode,
    decode_screen_video,
    encode_screen_video,
    read_flv_tags,
)
from mere_fusion_tpu_torch.transport.rtmp import RtmpStreamer, RtmpTrackSink
from mere_fusion_tpu_torch.transport.rtmp_native import (
    MSG_COMMAND_AMF0,
    RtmpPublisher,
    _ChunkReader,
    parse_rtmp_url,
)

JOIN_S = 30.0   # thread joins and socket reads: generous under a loaded run


def _img(seed, h=96, w=128):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


AMF0_VALUES = ["connect", 1.0, None, True,
               {"app": "live", "n": 3.5, "nested": {"x": False}}, ["a", 2.0, None], 7, "",
               {"": "empty key", "ü": "utf-8"}]


# ---- twins of tests/test_flv_rtmp_native.py ----------------------------------------

def test_screen_video_roundtrip_key_and_inter():
    a, b = _img(0), _img(0).copy()
    b[10:20, 10:20] = 255   # one dirty block
    key = encode_screen_video(a)
    np.testing.assert_array_equal(decode_screen_video(key), a)
    inter = encode_screen_video(b, prev_bgr=a)
    assert len(inter) < len(key), "an interframe skips the unchanged blocks"
    np.testing.assert_array_equal(decode_screen_video(inter, prev_bgr=a), b)


def test_amf0_roundtrip():
    vals = AMF0_VALUES[:6]
    buf = b"".join(amf0_encode(v) for v in vals)
    assert rtmp_native.decode_amf0_values(buf) == vals


def test_flv_writer_roundtrip():
    buf = io.BytesIO()
    w = FLVWriter(buf, 128, 96, fps=25, sample_rate=16000, gop=2)
    frames = [_img(i) for i in range(4)]
    pcm = np.linspace(-0.5, 0.5, 640, dtype=np.float32)
    for frame in frames:
        w.write_video(frame)
        w.write_audio(pcm)
    w.close()
    tags = read_flv_tags(buf.getvalue())
    script = [t for t in tags if t[0] == 18]
    name, offset = amf0_decode(script[0][2], 0)
    meta, _ = amf0_decode(script[0][2], offset)
    assert name == "onMetaData" and meta["videocodecid"] == 3
    vids = [t for t in tags if t[0] == 9]
    assert len(vids) == 4
    prev = None
    for (_, _ts, body), expect in zip(vids, frames):
        assert body[0] & 0x0F == 3   # Screen Video
        prev = decode_screen_video(body[1:], prev_bgr=prev)
        np.testing.assert_array_equal(prev, expect)
    auds = [t for t in tags if t[0] == 8]
    assert len(auds) == 4
    got = np.frombuffer(auds[0][2][1:], "<i2").astype(np.float32) / 32767
    np.testing.assert_allclose(got, pcm, atol=1e-4)
    assert [t[1] for t in vids] == [0, 40, 80, 120]
    assert [t[1] for t in auds] == [0, 40, 80, 120]


def test_parse_rtmp_url():
    assert parse_rtmp_url("rtmp://h/live/stream") == ("h", 1935, "live", "stream")
    assert parse_rtmp_url("rtmp://h:19350/app/sub/s1") == ("h", 19350, "app/sub", "s1")
    for bad in ("http://h/live/s", "rtmp://h/onlyapp"):
        with pytest.raises(rtmp_native.RtmpError):
            parse_rtmp_url(bad)
        with pytest.raises(jax_native.RtmpError):
            jax_native.parse_rtmp_url(bad)


def _wire_publisher(mod, sock):
    """``mod``'s RtmpPublisher reduced to its wire layer on ``sock``."""
    pub = mod.RtmpPublisher.__new__(mod.RtmpPublisher)
    pub._sock = sock
    pub._send_lock = threading.Lock()
    return pub


@pytest.mark.parametrize("writer_mod,reader_mod", [
    (rtmp_native, rtmp_native), (rtmp_native, jax_native), (jax_native, rtmp_native)],
    ids=["port", "port_to_jax", "jax_to_port"])
def test_extended_timestamp_roundtrip(writer_mod, reader_mod):
    """Messages past the 24-bit timestamp range survive the chunk writer and
    reader, in one chunk and in several."""
    a, b = socket.socketpair()
    b.settimeout(JOIN_S)
    pub = _wire_publisher(writer_mod, a)
    reader = reader_mod._ChunkReader(b)
    pub._send_message(2, 1, 0, struct.pack(">I", 4096))   # set chunk size
    big_ts = 0x1000000 + 1234                              # > 16.7 M ms (~4.6 h)
    pub._send_message(4, 9, 1, b"v" * 10, timestamp=big_ts)
    pub._send_message(4, 9, 1, b"w" * 9000, timestamp=big_ts + 40)   # chunked
    assert reader.read_message() == (9, 1, b"v" * 10)
    assert reader._streams[4]["ts"] == big_ts
    assert reader.read_message()[2] == b"w" * 9000
    assert reader._streams[4]["ts"] == big_ts + 40
    a.close()
    b.close()


def test_chunk_reader_header_formats_match_jax():
    """fmt 1, 2 and 3 headers and 2- and 3-byte chunk stream ids, read by both
    packages' readers from the same bytes."""
    def chunk(fmt, csid, rest):
        if csid < 64:
            return bytes([(fmt << 6) | csid]) + rest
        if csid < 320:
            return bytes([fmt << 6, csid - 64]) + rest
        return bytes([(fmt << 6) | 1, (csid - 64) & 0xFF, (csid - 64) >> 8]) + rest

    stream = (chunk(0, 5, (100).to_bytes(3, "big") + (4).to_bytes(3, "big") + bytes([9])
                    + (1).to_bytes(4, "little") + b"abcd")
              + chunk(1, 5, (40).to_bytes(3, "big") + (3).to_bytes(3, "big") + bytes([8]) + b"xyz")
              + chunk(2, 5, (20).to_bytes(3, "big") + b"pqr")
              + chunk(3, 5, b"stu")
              + chunk(0, 70, bytes(3) + (200).to_bytes(3, "big") + bytes([9]) + bytes(4)
                      + bytes(range(128)))
              + chunk(3, 70, bytes(range(72)))
              + chunk(0, 400, bytes(3) + (2).to_bytes(3, "big") + bytes([8]) + bytes(4) + b"zz"))
    out = []
    for mod in (rtmp_native, jax_native):
        a, b = socket.socketpair()
        a.sendall(stream)
        a.close()
        reader = mod._ChunkReader(b)
        out.append([(reader.read_message(), reader._streams[5]["ts"]) for _ in range(6)])
        b.close()
    assert out[0] == out[1]
    assert [m for m, _ in out[0]][:4] == [(9, 1, b"abcd"), (8, 1, b"xyz"), (8, 1, b"pqr"),
                                          (8, 1, b"stu")]
    assert [ts for _, ts in out[0][:4]] == [100, 140, 160, 180]


class MiniRtmpServer(threading.Thread):
    """Handshake, command replies and media collection, reading with
    ``reader_mod``'s chunk reader."""

    def __init__(self, reader_mod=rtmp_native, n_media: int = 6):
        super().__init__(daemon=True)
        self.reader_mod = reader_mod
        self.n_media = n_media
        self.listener = socket.socket()
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(1)
        self.port = self.listener.getsockname()[1]
        self.media = []
        self.metadata = None
        self.error = None

    def _send(self, sock, csid, msg_type, msid, payload):
        header = (bytes([csid & 0x3F]) + b"\x00\x00\x00" + len(payload).to_bytes(3, "big")
                  + bytes([msg_type]) + msid.to_bytes(4, "little"))
        sock.sendall(header + payload)   # the replies fit one 128-byte chunk

    def run(self):
        try:
            self.listener.settimeout(JOIN_S)
            sock, _ = self.listener.accept()
            sock.settimeout(JOIN_S)
            reader = self.reader_mod._ChunkReader(sock)
            c0c1 = reader._recv(1537)
            assert c0c1[0] == 3
            sock.sendall(b"\x03" + struct.pack(">II", 0, 0) + bytes(1528) + c0c1[1:])  # s0 s1 s2
            reader._recv(1536)   # c2
            while len(self.media) < self.n_media:
                msg_type, msid, payload = reader.read_message()
                if msg_type == MSG_COMMAND_AMF0:
                    name, txn = rtmp_native.decode_amf0_values(payload)[:2]
                    if name == "connect":
                        self._send(sock, 3, MSG_COMMAND_AMF0, 0,
                                   amf0_encode("_result") + amf0_encode(txn)
                                   + amf0_encode({"fmsVer": "FMS/3"})
                                   + amf0_encode({"level": "status"}))
                    elif name == "createStream":
                        self._send(sock, 3, MSG_COMMAND_AMF0, 0,
                                   amf0_encode("_result") + amf0_encode(txn)
                                   + amf0_encode(None) + amf0_encode(1.0))
                    elif name == "publish":
                        self._send(sock, 3, MSG_COMMAND_AMF0, 1,
                                   amf0_encode("onStatus") + amf0_encode(0.0) + amf0_encode(None)
                                   + amf0_encode({"code": "NetStream.Publish.Start"}))
                elif msg_type == 18:
                    self.metadata = rtmp_native.decode_amf0_values(payload)[2]
                elif msg_type in (8, 9):
                    self.media.append((msg_type, payload))
            sock.close()
        except Exception as e:   # surfaced in the test's thread
            self.error = e
        finally:
            self.listener.close()


@pytest.mark.parametrize("reader_mod", [rtmp_native, jax_native], ids=["port", "jax_reader"])
def test_publisher_against_mini_server(reader_mod):
    server = MiniRtmpServer(reader_mod)
    server.start()
    pub = RtmpPublisher(f"rtmp://127.0.0.1:{server.port}/live/cam")
    frame = _img(7)
    body = bytes([(1 << 4) | 3]) + encode_screen_video(frame)
    pub.send_metadata({"width": 128.0, "height": 96.0})
    for i in range(3):
        pub.send_video(body, i * 40)
        pub.send_audio(b"\x36" + b"\x00\x01" * 320, i * 40)
    server.join(timeout=JOIN_S)
    pub.close()
    assert not server.is_alive() and server.error is None, server.error
    assert server.metadata["width"] == 128.0
    vids = [p for t, p in server.media if t == 9]
    auds = [p for t, p in server.media if t == 8]
    assert len(vids) == 3 and len(auds) == 3
    np.testing.assert_array_equal(decode_screen_video(vids[0][1:]), frame)


def test_rtmp_streamer_native_fallback_end_to_end():
    server = MiniRtmpServer()
    server.start()
    streamer = RtmpStreamer(f"rtmp://127.0.0.1:{server.port}/live/x", width=128, height=96,
                            force_native=True)
    assert streamer.route == "native"
    frame = _img(9)
    for _ in range(3):
        streamer.stream_frame(frame)
        streamer.stream_frame_audio(np.zeros(320, np.float32))
    with pytest.raises(ValueError, match="configured"):
        streamer.stream_frame(frame[:10])
    server.join(timeout=JOIN_S)
    streamer.close()
    assert not server.is_alive() and server.error is None, server.error
    assert server.metadata["videocodecid"] == 3
    vids = [p for t, p in server.media if t == 9]
    assert len(vids) == 3
    assert vids[0][0] >> 4 == 1   # keyframe
    assert vids[1][0] >> 4 == 2   # interframe
    np.testing.assert_array_equal(decode_screen_video(vids[0][1:]), frame)


def test_rtmp_track_sink_pumps_both_tracks():
    """RtmpTrackSink drains a session's paced tracks into the streamer: the
    frames as sent, int16 samples as float PCM."""
    import asyncio

    from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage

    class Track:
        def __init__(self, items):
            self.items = list(items)

        async def recv(self):
            if not self.items:
                await asyncio.sleep(3600)   # cancelled at the end
            return self.items.pop(0)

    class Streamer:
        def __init__(self):
            self.frames, self.pcm = [], []

        def stream_frame(self, image):
            self.frames.append(image)

        def stream_frame_audio(self, chunk):
            self.pcm.append(chunk)

    quit_event = threading.Event()
    frames = [_img(i, 8, 8) for i in range(3)]
    chunks = [np.full(320, v, np.int16) for v in (-32768, 0, 16384)]
    sink = RtmpTrackSink(Streamer())

    async def main():
        task = asyncio.ensure_future(sink.run(Track(VideoImage(f) for f in frames),
                                              Track(AudioChunk(c) for c in chunks), quit_event))
        for _ in range(100):
            await asyncio.sleep(0.01)
            if len(sink.streamer.pcm) == 3 and len(sink.streamer.frames) == 3:
                break
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)

    asyncio.run(main())
    assert all(a is b for a, b in zip(sink.streamer.frames, frames))
    np.testing.assert_array_equal(np.stack(sink.streamer.pcm)[:, 0], [-1.0, 0.0, 0.5])


# ---- twin of tests/test_misc_transport.py::test_rtmp_streamer_pipes_video_and_audio ---

def test_rtmp_streamer_pipes_video_and_audio(tmp_path):
    """The ffmpeg route: raw BGR frames on stdin, PCM16 through the audio
    FIFO. A recorder script stands in for ffmpeg (absent here)."""
    vid_out, aud_out = tmp_path / "video.bin", tmp_path / "audio.bin"
    fake = tmp_path / "fake_ffmpeg.py"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, threading\n"
        "args = sys.argv[1:]\n"
        "fifo = args[args.index('s16le') + 6]\n"   # '-f s16le -ar R -ac 1 -i FIFO'
        "def drain_fifo():\n"
        f"    open({str(aud_out)!r}, 'wb').write(open(fifo, 'rb').read())\n"
        "t = threading.Thread(target=drain_fifo); t.start()\n"
        f"open({str(vid_out)!r}, 'wb').write(sys.stdin.buffer.read())\n"
        "t.join()\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    h, w = 4, 6
    s = RtmpStreamer("rtmp://example/live", width=w, height=h, fps=25, ffmpeg_path=str(fake))
    assert s.route == "ffmpeg"
    frame = np.arange(h * w * 3, dtype=np.uint8).reshape(h, w, 3)
    pcm = np.linspace(-1, 1, 320).astype(np.float32)
    s.stream_frame(frame)
    s.stream_frame_audio(pcm)
    s.close()
    assert vid_out.read_bytes() == frame.tobytes()
    np.testing.assert_array_equal(np.frombuffer(aud_out.read_bytes(), np.int16),
                                  (pcm * 32767).astype(np.int16))


# ---- byte parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("shape", [(96, 128), (240, 320), (50, 70)])
def test_screen_video_bytes_equal_to_jax(shape):
    a = _img(1, *shape)
    b = a.copy()
    b[: shape[0] // 3, : shape[1] // 2] = 7
    assert encode_screen_video(a) == jax_flv.encode_screen_video(a)
    inter = encode_screen_video(b, prev_bgr=a)
    assert inter == jax_flv.encode_screen_video(b, prev_bgr=a)
    np.testing.assert_array_equal(decode_screen_video(inter, a),
                                  jax_flv.decode_screen_video(inter, a))
    np.testing.assert_array_equal(jax_flv.decode_screen_video(encode_screen_video(a)), a)


def test_amf0_bytes_equal_to_jax():
    for v in AMF0_VALUES:
        raw = amf0_encode(v)
        assert raw == jax_flv.amf0_encode(v)
        assert amf0_decode(raw) == jax_flv.amf0_decode(raw)
    ecma = b"\x08\x00\x00\x00\x01" + b"\x00\x01k" + amf0_encode(2.5) + b"\x00\x00\x09" + b"\x06"
    assert amf0_decode(ecma) == jax_flv.amf0_decode(ecma) == ({"k": 2.5}, len(ecma) - 1)
    with pytest.raises(TypeError):
        amf0_encode(object())


def test_flv_tags_and_writer_bytes_equal_to_jax():
    for tag, ts, body in ((9, 0, b""), (8, 40, b"\x36" * 641), (18, 0x1234567, b"x" * 70000)):
        assert flv.flv_tag(tag, ts, body) == jax_flv.flv_tag(tag, ts, body)
    files = []
    rng = np.random.default_rng(2)
    frames = [_img(i, 64, 80) for i in range(5)]
    frames[2] = frames[1].copy()   # an interframe of empty blocks
    pcm = [rng.uniform(-1.2, 1.2, 320).astype(np.float32) for _ in range(10)]
    for mod in (flv, jax_flv):
        buf = io.BytesIO()
        w = mod.FLVWriter(buf, 80, 64, fps=25, sample_rate=16000, gop=3)
        for i, frame in enumerate(frames):
            w.write_video(frame)
            w.write_audio(pcm[2 * i])
            w.write_audio(pcm[2 * i + 1])
        w.close()
        files.append(buf.getvalue())
    assert files[0] == files[1]
    assert read_flv_tags(files[0]) == jax_flv.read_flv_tags(files[0])


def test_chunk_writer_bytes_equal_to_jax():
    """The RTMP messages the publisher writes (commands, metadata, media
    across chunks, extended timestamps) are the JAX package's bytes."""
    sent = []
    for mod in (rtmp_native, jax_native):
        a, b = socket.socketpair()
        pub = _wire_publisher(mod, a)
        pub._txn, pub._msid = 0, 1
        pub._command("connect", {"app": "live", "tcUrl": "rtmp://h/live"})
        pub._command("publish", None, "s", "live", msid=1)
        pub.send_metadata(flv.FlvPacketizer(80, 64).metadata())
        pub.send_video(b"\x13" + encode_screen_video(_img(4, 64, 80)), 40)
        pub.send_audio(b"\x36" + bytes(640), 0xFFFFFF + 5)
        a.close()
        data = b""
        while chunk := b.recv(1 << 16):
            data += chunk
        b.close()
        sent.append(data)
    assert len(sent[0]) > 4096 and sent[0] == sent[1]
