"""The port's RTP legs against the JAX package's: transport/rtp.py,
transport/rtp_send.py and transport/line_packet.py.

Twins of tests/test_rtp_native.py, tests/test_rtp_send.py and the line
protocol test of tests/test_misc_transport.py, then byte parity (the same
seeded frames and PCM give the same RTP and RTCP datagrams from both
packages), decoding across the packages in both directions, the ffmpeg-pipe
ingests through a stand-in ffmpeg, and a live Wav2Lip session of the port
over UDP whose received frames equal the frames it emitted.
"""
from __future__ import annotations

import asyncio
import os
import socket
import stat
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mere_fusion_tpu.transport import line_packet as jax_lp
from mere_fusion_tpu.transport import rtp as jax_rtp
from mere_fusion_tpu.transport import rtp_send as jax_send
from mere_fusion_tpu_torch.transport import line_packet, rtp, rtp_send
from mere_fusion_tpu_torch.transport.rtp import (
    alaw_decode,
    decode_rtp_audio,
    parse_rtp_packet,
    rtp_native_audio_chunks,
    ulaw_decode,
)
from mere_fusion_tpu_torch.transport.rtp_send import (
    L16_PAYLOAD_TYPE,
    RtpSender,
    rtp_native_video_frames,
)

JOIN_S = 30.0   # thread joins: generous under a loaded multi-worker run


def _packet(pt, seq, ts, payload, csrc=0, ext=b"", pad=0):
    b0 = 0x80 | (0x10 if ext else 0) | (0x20 if pad else 0) | csrc
    head = struct.pack("!BBHII", b0, pt, seq, ts, 0x1234)
    head += b"\x00" * (4 * csrc)
    if ext:
        head += struct.pack("!HH", 0xBEDE, len(ext) // 4) + ext
    tail = (b"\x00" * (pad - 1) + bytes([pad])) if pad else b""
    return head + payload + tail


def _udp_pair():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    # room for a few 240×320 frames (~170 datagrams each) while a loaded
    # host delays the reader; the kernel caps it at its rmem_max
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    rx.bind(("127.0.0.1", 0))
    return rx, rx.getsockname()[1]


def ulaw_encode(x: np.ndarray) -> bytes:
    """int16 → G.711 µ-law bytes, on the 14-bit magnitude as
    audioop.lin2ulaw computes them."""
    pcm = x.astype(np.int32) >> 2
    mask = np.where(pcm < 0, 0x7F, 0xFF)
    pcm = np.minimum(np.abs(pcm), 8159) + 0x21
    seg = np.searchsorted([0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF], pcm)
    u = np.where(seg >= 8, 0x7F, (np.minimum(seg, 7) << 4) | ((pcm >> (np.minimum(seg, 7) + 1)) & 0xF))
    return (u ^ mask).astype(np.uint8).tobytes()


class Recorder:
    """A socket stand-in that keeps every datagram sent through it."""

    def __init__(self):
        self.sent: list[tuple[bytes, tuple]] = []

    def sendto(self, data, addr):
        self.sent.append((bytes(data), addr))

    def close(self):
        pass


class Replay:
    """A bound-socket stand-in that hands out recorded datagrams, then times
    out; ``timestamps`` holds the RTP timestamp of each datagram read."""

    def __init__(self, datagrams):
        self._data = list(datagrams)
        self.timestamps: list[int] = []

    def settimeout(self, _t):
        pass

    def recvfrom(self, _n):
        if not self._data:
            raise socket.timeout
        data = self._data.pop(0)
        if len(data) >= 12:
            self.timestamps.append(struct.unpack("!I", data[4:8])[0])
        return data, ("127.0.0.1", 1)


def _recording_sender(mod, ssrc=(0x11223344, 0x55667788), seq=(100, 0xFFFD), rtcp=False):
    """``mod``'s RtpSender with its socket replaced by a Recorder and its
    SSRCs and first sequence numbers fixed."""
    sender = mod.RtpSender("127.0.0.1", audio_port=5004, video_port=5006, rtcp=rtcp)
    sender.sock.close()
    rec = Recorder()
    sender.sock = rec
    for stream, s, q in zip((sender.audio, sender.video), ssrc, seq):
        stream.sock, stream.ssrc, stream.seq = rec, s, q
    return sender, rec


def _frames(seed=0, shapes=((48, 64), (2, 640), (31, 47))):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in shapes]


def _pcm(seed=1, n=10):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-0.9, 0.9, 320) * 32767).astype(np.int16) for _ in range(n)]


# ---- twins of tests/test_rtp_native.py ---------------------------------------------

def test_ulaw_alaw_match_audioop():
    tone = (np.sin(np.linspace(0, 60, 800)) * 16000).astype(np.int16)
    if sys.version_info < (3, 13):
        import audioop

        assert ulaw_encode(tone) == audioop.lin2ulaw(tone.tobytes(), 2)
    all_bytes = bytes(range(256))
    for port_fn, jax_fn, name in ((ulaw_decode, jax_rtp.ulaw_decode, "ulaw2lin"),
                                  (alaw_decode, jax_rtp.alaw_decode, "alaw2lin")):
        got = port_fn(all_bytes)
        np.testing.assert_array_equal(got, jax_fn(all_bytes))
        if sys.version_info < (3, 13):   # audioop left the standard library in 3.13
            import audioop

            np.testing.assert_array_equal(
                got, np.frombuffer(getattr(audioop, name)(all_bytes, 2), np.int16))


def test_parse_rtp_packet_variants():
    payload = b"\x11" * 20
    packets = [_packet(0, 7, 160, payload), _packet(8, 7, 160, payload, csrc=2),
               _packet(0, 7, 160, payload, ext=b"\xde\xad\xbe\xef"),
               _packet(0, 7, 160, payload, pad=3)]
    for p in packets:
        assert parse_rtp_packet(p)[3] == payload
    assert parse_rtp_packet(b"\x00" * 11) is None          # too short
    assert parse_rtp_packet(b"\x00" * 16) is None          # wrong version
    pt, seq, ts, _ = parse_rtp_packet(_packet(11, 99, 320, payload))
    assert (pt, seq, ts) == (11, 99, 320)
    odd = [b"\x80" * 12, _packet(0, 1, 2, b"", pad=0) + b"\x90",
           b"\x90" + b"\x00" * 12, b"\xa0" + b"\x00" * 11 + b"\xff"]
    for p in packets + odd:
        assert parse_rtp_packet(p) == jax_rtp.parse_rtp_packet(p)


def test_decode_rtp_audio_l16():
    sig = (np.sin(np.linspace(0, 9, 160)) * 20000).astype(np.int16)
    out, rate = decode_rtp_audio(11, sig.astype(">i2").tobytes())
    assert rate == 44100                                    # RFC 3551 static
    np.testing.assert_array_equal(out, sig)
    out, rate = decode_rtp_audio(96, sig.astype(">i2").tobytes(),
                                 l16_payload_type=96, l16_rate=16000)
    assert rate == 16000
    np.testing.assert_array_equal(out, sig)
    assert decode_rtp_audio(96, b"xx") is None              # unknown pt
    odd = sig.astype(">i2").tobytes() + b"\x01"              # a trailing odd byte
    np.testing.assert_array_equal(decode_rtp_audio(11, odd)[0], jax_rtp.decode_rtp_audio(11, odd)[0])


def _ingest_datagrams():
    rng = np.random.default_rng(0)
    sig = (rng.uniform(-0.5, 0.5, 3200) * 32767).astype(np.int16)   # 0.2 s L16
    out = [_packet(96, 100 + i, i * 320, sig[i * 320 : (i + 1) * 320].astype(">i2").tobytes())
           for i in range(10)]
    # a duplicate and a stale packet, both dropped
    out += [_packet(96, 109, 9 * 320, b"\x7f\xff" * 320), _packet(96, 50, 0, b"\x7f\xff" * 320)]
    # then PCMU at 8 kHz, resampled 2x by the receiver
    tone = (np.sin(np.linspace(0, 60, 800)) * 16000).astype(np.int16)
    ulaw = ulaw_encode(tone)
    out += [_packet(0, 110 + i, 3200 + i * 160, ulaw[i * 160 : (i + 1) * 160]) for i in range(5)]
    return sig, tone, out


def test_native_receiver_end_to_end_l16_and_pcmu():
    recv, addr = _udp_pair()
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sig, tone, datagrams = _ingest_datagrams()
    for d in datagrams:
        send.sendto(d, ("127.0.0.1", addr))
    kw = dict(sample_rate=16000, chunk_seconds=0.1, timeout=1.0,
              l16_payload_type=96, l16_rate=16000)
    try:
        chunks = list(rtp_native_audio_chunks(sock=recv, **kw))
    finally:
        send.close()
        recv.close()
    got = np.concatenate(chunks)
    # 0.2 s of L16 and 0.1 s of PCMU upsampled to 16 kHz
    assert len(got) == 4800
    np.testing.assert_allclose(got[:3200], sig / 32768.0, atol=1e-4)
    # µ-law quantisation: a coarse check, but clearly the same tone
    assert np.corrcoef(got[3200:][::2][:400], (tone / 32768.0)[:400])[0, 1] > 0.99
    # the JAX receiver makes the same chunks of the same datagrams
    ref = list(jax_rtp.rtp_native_audio_chunks(sock=Replay(datagrams), **kw))
    assert [c.shape for c in chunks] == [c.shape for c in ref]
    np.testing.assert_allclose(got, np.concatenate(ref), atol=1e-6)


# ---- twins of tests/test_rtp_send.py ------------------------------------------------

def _receive(gen, n):
    got = []
    t = threading.Thread(target=lambda: got.extend(f.copy() for _, f in zip(range(n), gen)))
    t.start()
    return got, t


def test_video_roundtrip_rfc4175():
    rx, port = _udp_pair()
    sender = RtpSender("127.0.0.1", audio_port=1, video_port=port, rtcp=False)
    frames = [np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
              for _ in range(3)]
    got, t = _receive(rtp_native_video_frames(width=64, height=48, sock=rx, timeout=5.0), 3)
    for i, f in enumerate(frames):
        sender.send_video(f, ts=i * 3600)
    t.join(timeout=JOIN_S)
    sender.close()
    rx.close()
    assert not t.is_alive() and len(got) == 3
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)


def test_video_wide_lines_fragment():
    """A 640-px line exceeds one packet's payload: lines span packets."""
    rx, port = _udp_pair()
    sender = RtpSender("127.0.0.1", audio_port=1, video_port=port, rtcp=False)
    frame = np.arange(2 * 640 * 3, dtype=np.uint8).reshape(2, 640, 3)
    got, t = _receive(rtp_native_video_frames(width=640, height=2, sock=rx, timeout=5.0), 1)
    sender.send_video(frame, ts=0)
    t.join(timeout=JOIN_S)
    sender.close()
    rx.close()
    assert not t.is_alive() and len(got) == 1
    np.testing.assert_array_equal(got[0], frame)


def test_video_extended_seq_is_32bit_counter():
    """RFC 4175 §4.1: the extended sequence number is the high 16 bits of the
    stream's 32-bit packet counter, so (ext << 16) | seq rises across the
    16-bit wrap."""
    sender, rec = _recording_sender(rtp_send, seq=(0, 0xFFFD))
    for i in range(3):
        sender.send_video(np.zeros((8, 64, 3), np.uint8), ts=i * 3600)
    seqs = [(struct.unpack("!H", d[12:14])[0] << 16) | struct.unpack("!H", d[2:4])[0]
            for d, _ in rec.sent]
    assert len(seqs) >= 4
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs), seqs
    assert any(s >= 0x10000 for s in seqs) and any(s < 0x10000 for s in seqs)


def test_audio_roundtrip_l16():
    rx, port = _udp_pair()
    sender = RtpSender("127.0.0.1", audio_port=port, video_port=1, rtcp=False)
    pcm = (np.sin(np.linspace(0, 30, 3200)) * 20000).astype(np.int16)
    recv = rtp_native_audio_chunks(sock=rx, sample_rate=16000, chunk_seconds=0.2,
                                   l16_payload_type=L16_PAYLOAD_TYPE, l16_rate=16000,
                                   timeout=1.5)
    got = []
    t = threading.Thread(target=lambda: got.extend(recv))
    t.start()
    for i, c in enumerate(pcm.reshape(10, 320)):
        sender.send_audio(c, ts=i * 320)
    t.join(timeout=JOIN_S)
    sender.close()
    rx.close()
    assert not t.is_alive()
    received = np.concatenate(got)
    assert received.shape[0] == 3200
    np.testing.assert_allclose(received, pcm.astype(np.float32) / 32768.0, atol=1e-4)


def test_rtcp_sender_report_emitted():
    rtcp_rx, rtcp_port = _udp_pair()          # the report goes to the audio port + 1
    rtcp_rx.settimeout(JOIN_S)
    sender = RtpSender("127.0.0.1", audio_port=rtcp_port - 1, video_port=1)
    try:
        sender.send_audio(np.zeros(320, np.int16), ts=0)
        data, _ = rtcp_rx.recvfrom(2048)
    finally:
        sender.close()
        rtcp_rx.close()
    assert struct.unpack("!BB", data[:2]) == (0x80, 200)   # RTCP SR
    (_, _, _, ssrc, _ntps, _ntpf, rtp_ts, pkts, octets) = struct.unpack("!BBHIIIIII", data[:28])
    assert ssrc == sender.audio.ssrc
    assert pkts == 1 and octets == 640 and rtp_ts == 0


# ---- twin of tests/test_misc_transport.py::test_line_packet_roundtrip ----------------

@pytest.mark.parametrize("sender_mod", [line_packet, jax_lp], ids=["port", "jax_sender"])
def test_line_packet_roundtrip(sender_mod):
    server, client = socket.socketpair()
    server.settimeout(JOIN_S)
    results = []

    def reader():
        results.append(line_packet.receive_one_line(server))
        results.append(line_packet.receive_lines(server))

    t = threading.Thread(target=reader)
    t.start()
    sender_mod.send_one_line(client, "hello transcription")
    sender_mod.send_one_line(client, "line a\0line b")
    t.join(timeout=JOIN_S)
    client.close()
    assert not t.is_alive()
    assert results[0] == "hello transcription\n"
    assert results[1] == ["line a"]        # only the first line is sent
    assert line_packet.receive_one_line(server) is None   # closed
    server.close()


class _Chunked:
    """A socket stand-in whose recv returns at most ``n`` bytes: a packet
    arrives in pieces, as it may on a loaded host."""

    def __init__(self, data: bytes, n: int):
        self.data, self.n = data, n

    def recv(self, size):
        out, self.data = self.data[: min(size, self.n)], self.data[min(size, self.n):]
        return out


def test_line_packet_reads_whole_packets_where_jax_desyncs():
    """ROADMAP §3: when a packet arrives in pieces, the JAX receiver stops at
    the piece holding the NUL and reads the packet's remaining padding as
    the next line; the port reads each whole packet."""
    sent = []
    rec = type("S", (), {"sendall": lambda self, d: sent.append(bytes(d))})()
    line_packet.send_one_line(rec, "hello transcription")
    line_packet.send_one_line(rec, "line a\0line b")
    data = b"".join(sent)
    port = _Chunked(data, 4096)
    assert line_packet.receive_one_line(port) == "hello transcription\n"
    assert line_packet.receive_lines(port) == ["line a"]
    assert line_packet.receive_one_line(port) is None
    ref = _Chunked(data, 4096)
    assert jax_lp.receive_one_line(ref) == "hello transcription\n"
    assert jax_lp.receive_lines(ref) == []      # the first packet's padding
    whole = _Chunked(data, line_packet.PACKET_SIZE)   # whole packets: both agree
    assert jax_lp.receive_one_line(whole) == "hello transcription\n"
    assert jax_lp.receive_lines(whole) == ["line a"]


def test_line_packet_bytes_equal_to_jax():
    for text in ("hello", "", "a\nb", "x\0y", "ü" * 40000):
        sent = []
        for mod in (line_packet, jax_lp):
            rec = type("S", (), {"sendall": lambda self, d: sent.append(bytes(d))})()
            mod.send_one_line(rec, text)
        assert sent[0] == sent[1] and len(sent[0]) == line_packet.PACKET_SIZE


# ---- byte parity and cross-decoding ------------------------------------------------

def _send_all(mod, frames, pcm, rtcp=False):
    sender, rec = _recording_sender(mod, rtcp=rtcp)
    for i, f in enumerate(frames):
        sender.send_video(f, ts=i * 3600)
    for i, c in enumerate(pcm):
        sender.send_audio(c, ts=i * 320)
    return rec.sent


def test_rtp_packets_bit_equal_to_jax():
    frames, pcm = _frames(), _pcm()
    port, ref = _send_all(rtp_send, frames, pcm), _send_all(jax_send, frames, pcm)
    assert len(port) == len(ref) > 20          # the 0xFFFD video start wraps the base
    assert port == ref


def test_rtcp_sender_report_bit_equal_to_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.123456)
    frames, pcm = _frames()[:1], _pcm(n=2)
    port, ref = (_send_all(m, frames, pcm, rtcp=True) for m in (rtp_send, jax_send))
    reports = [d for d, addr in port if d[1] == 200]
    assert [addr for d, addr in port if d[1] == 200] == [("127.0.0.1", 5007), ("127.0.0.1", 5005)]
    assert len(reports) == 2 and port == ref


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_cross_decoding(direction):
    """One package's sender into the other's receivers: the frames and PCM
    come back exactly."""
    send_mod, recv_rtp, recv_send = ((rtp_send, jax_rtp, jax_send) if direction == "port_to_jax"
                                     else (jax_send, rtp, rtp_send))
    shapes = ((48, 64), (48, 64), (48, 64))
    frames, pcm = _frames(seed=3, shapes=shapes), _pcm(seed=4)
    sent = _send_all(send_mod, frames, pcm)
    video = [d for d, addr in sent if addr[1] == 5006]
    audio = [d for d, addr in sent if addr[1] == 5004]
    got = [f.copy() for f in recv_send.rtp_native_video_frames(
        width=64, height=48, sock=Replay(video))]
    assert len(got) == 3
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    chunks = list(recv_rtp.rtp_native_audio_chunks(
        sock=Replay(audio), chunk_seconds=0.2, l16_payload_type=96, l16_rate=16000))
    want = np.concatenate(pcm).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(np.concatenate(chunks), want)


def test_video_receiver_drops_late_and_duplicate_packets_as_jax():
    """Reorders across frames and a timestamp wrap: both receivers keep and
    drop the same packets."""
    sender, rec = _recording_sender(rtp_send)
    frames = _frames(seed=5, shapes=((20, 64),) * 4)
    for i, f in enumerate(frames):
        sender.send_video(f, ts=(0xFFFFFFFF - 3600 + i * 3600) & 0xFFFFFFFF)   # wraps
    pkts = [d for d, _ in rec.sent]
    per = len(pkts) // 4
    stream = (pkts[:per] + pkts[per : 2 * per - 1] + pkts[:1]          # a late packet of frame 0
              + [pkts[2 * per - 1]] + [pkts[2 * per - 1]]               # frame 1's tail twice
              + pkts[2 * per :])
    outs = []
    for mod in (rtp_send, jax_send):
        r = Replay(stream)
        outs.append([(f.copy(), r.timestamps[-1]) for f in mod.rtp_native_video_frames(
            width=64, height=20, sock=r)])
    assert len(outs[0]) == len(outs[1]) == 4
    for (a, ta), (b, tb), f in zip(*outs, frames):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, f)


# ---- the ffmpeg-pipe ingests, through a stand-in ffmpeg -----------------------------

def test_ffmpeg_ingests_match_jax(tmp_path, monkeypatch):
    """rtp_audio_chunks and rtp_video_frames read what ffmpeg writes; a
    script named ffmpeg on the PATH writes seeded bytes."""
    rng = np.random.default_rng(6)
    (tmp_path / "pcm.bin").write_bytes((rng.integers(-32768, 32767, 40000)).astype(np.int16).tobytes())
    (tmp_path / "bgr.bin").write_bytes(rng.integers(0, 256, 3 * 12 * 16 * 3, np.uint8).tobytes())
    fake = tmp_path / "ffmpeg"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "name = 'bgr.bin' if 'rawvideo' in sys.argv else 'pcm.bin'\n"
        f"sys.stdout.buffer.write(open({str(tmp_path)!r} + '/' + name, 'rb').read())\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    a = list(rtp.rtp_audio_chunks("rtp://x", chunk_seconds=1.0))
    b = list(jax_rtp.rtp_audio_chunks("rtp://x", chunk_seconds=1.0))
    assert [len(c) for c in a] == [16000, 16000, 8000]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    a = list(rtp.rtp_video_frames("rtp://x", 16, 12))
    b = list(jax_rtp.rtp_video_frames("rtp://x", 16, 12))
    assert len(a) == 3 and all(f.shape == (12, 16, 3) for f in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---- a live port session over rtp ----------------------------------------------------

class TsSocket:
    """A UDP socket wrapper that keeps the RTP timestamp of the last
    datagram read: the timestamp of the frame a receiver just yielded."""

    def __init__(self, sock):
        self.sock = sock
        self.last_ts = None

    def settimeout(self, t):
        self.sock.settimeout(t)

    def recvfrom(self, n):
        data, addr = self.sock.recvfrom(n)
        if len(data) >= 12:
            self.last_ts = struct.unpack("!I", data[4:8])[0]
        return data, addr


def test_live_session_streams_over_rtp(tmp_path):
    """A live Wav2Lip session of the port pushes paced 25 fps video and
    50 Hz audio over UDP: at least 12 frames and 1 s of audio arrive, each
    frame bit-equal to the frame the session emitted with that pts."""
    from mere_fusion_tpu_torch.config import Config
    from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
    from mere_fusion_tpu_torch.engines.lip import LipReal
    from mere_fusion_tpu_torch.server.sessions import SessionManager

    while True:   # the sender's RTCP reports go to each port + 1
        (a_rx, a_port), (v_rx, v_port) = _udp_pair(), _udp_pair()
        if abs(a_port - v_port) != 1:
            break
        a_rx.close()
        v_rx.close()
    avatar = synthesize_avatar(str(tmp_path), n_frames=4)
    cfg = Config().override(**{
        "avatar.batch_size": 2, "tts.backend": "procedural", "avatar.dtype": "float32",
        "transport.mode": "rtp", "transport.rtp_host": "127.0.0.1",
        "transport.rtp_audio_port": a_port, "transport.rtp_video_port": v_port})
    h, w = avatar.frame_cycle[0].shape[:2]
    video, audio, emitted = [], [], []
    v_sock = TsSocket(v_rx)

    def collect_video():
        for f in rtp_native_video_frames(width=w, height=h, sock=v_sock, timeout=60.0):
            video.append((v_sock.last_ts, f.copy()))
            if len(video) >= 12:
                break

    def collect_audio():
        for c in rtp_native_audio_chunks(sock=a_rx, sample_rate=16000, chunk_seconds=0.1,
                                         l16_payload_type=L16_PAYLOAD_TYPE, l16_rate=16000,
                                         timeout=60.0):
            audio.append(c)
            if len(audio) >= 10:
                break

    threads = [threading.Thread(target=collect_video), threading.Thread(target=collect_audio)]
    for t in threads:
        t.start()

    def factory(c, device=None):
        engine = LipReal(c, avatar=avatar, device=device)
        record = engine.record_video_frame

        def tap(frame):            # the emitted VideoImage; its track sets .pts
            emitted.append(frame)
            record(frame)

        engine.record_video_frame = tap
        return engine

    mgr = SessionManager(cfg, factory, devices=[torch.device("cpu")])

    async def main():
        session = await mgr.start_session()
        assert session.model.first_video_frame_shape() == (h, w)
        session.model.put_msg_txt("hello over rtp")
        for _ in range(240):
            await asyncio.sleep(0.25)
            if len(video) >= 12 and len(audio) >= 10:
                break
        await mgr.close_all()

    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)   # a quieter neighbour to the other test workers
    try:
        asyncio.run(main())
    finally:
        torch.set_num_threads(n_threads)
    for t in threads:
        t.join(timeout=JOIN_S)
    a_rx.close()
    v_rx.close()
    assert not any(t.is_alive() for t in threads)
    assert len(video) >= 12, f"only {len(video)} video frames"
    assert sum(c.shape[0] for c in audio) >= 16000     # at least 1 s of audio
    by_pts = {f.pts: f.image for f in emitted if f.pts is not None}
    for ts, frame in video:
        np.testing.assert_array_equal(frame, by_pts[ts])
