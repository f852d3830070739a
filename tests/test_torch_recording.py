"""Session recording in the PyTorch port against the JAX package.

The port's MP4Writer writes the same bytes as JAX's for the same frames and
audio (odd-size audio re-blocked into 20 ms chunks, a zero-padded tail, the
sparse past-4-GiB file with its 64-bit mdat header and co64 offsets); its
BaseReal records to .mp4, .flv and .split.mp4 files equal to JAX's
BaseReal's for the same queued frames and chunks; the engines' assembly
loops tap their audio as JAX's do, so a Wav2Lip session on the CPU records
every frame it queued (each video sample the JPEG of the emitted frame at
quality 90) and every 20 ms chunk, and an ER-NeRF session records both
tracks. Twins of tests/test_recording.py and of
tests/test_flv_rtmp_native.py::test_engine_flv_recording.
"""
from __future__ import annotations

import asyncio
import io
import os
import struct
import threading
import time
import wave
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mere_fusion_tpu.config import Config as JConfig
from mere_fusion_tpu.engines.base import BaseReal as JBaseReal
from mere_fusion_tpu.transport import mp4 as jmp4
from mere_fusion_tpu.transport.frames import AudioChunk as JAudioChunk
from mere_fusion_tpu.transport.frames import VideoImage as JVideoImage
from mere_fusion_tpu_torch.config import Config
from mere_fusion_tpu_torch.data.provider import synthesize_nerf_dataset
from mere_fusion_tpu_torch.engines import make_engine
from mere_fusion_tpu_torch.engines.avatar import synthesize_avatar
from mere_fusion_tpu_torch.engines.base import BaseReal
from mere_fusion_tpu_torch.engines.lip import LipReal
from mere_fusion_tpu_torch.runtime.metrics import metrics
from mere_fusion_tpu_torch.server.app import create_app
from mere_fusion_tpu_torch.transport import mp4
from mere_fusion_tpu_torch.transport.flv import decode_screen_video, read_flv_tags
from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _children(data, start, end):
    return {t: (s, e) for t, s, e in mp4.parse_boxes(data, start, end)}


def _walk(data, span, *path):
    for typ in path:
        span = _children(data, *span)[typ]
    return span


def mp4_samples(data: bytes) -> tuple[list[bytes], np.ndarray]:
    """(each video sample's bytes, the PCM) of a recorded MP4, read back
    through its sample tables with the port's parse_boxes."""
    moov = _children(data, 0, len(data))[b"moov"]
    traks = [(s, e) for t, s, e in mp4.parse_boxes(data, *moov) if t == b"trak"]
    video, pcm = [], np.zeros(0, np.int16)
    for trak in traks:
        tables = _children(data, *_walk(data, trak, b"mdia", b"minf", b"stbl"))
        z, _ = tables[b"stsz"]
        size, count = struct.unpack(">II", data[z + 4:z + 12])
        s, _ = tables[b"stco"]
        (n,) = struct.unpack(">I", data[s + 4:s + 8])
        offsets = struct.unpack(f">{n}I", data[s + 8:s + 8 + 4 * n])
        if size == 0:                                   # video: a size a sample
            sizes = struct.unpack(f">{count}I", data[z + 12:z + 12 + 4 * count])
            video = [data[o:o + k] for o, k in zip(offsets, sizes)]
        else:                                            # PCM: 2 bytes a sample
            per_chunk = count // n
            pcm = np.concatenate([np.frombuffer(data[o:o + 2 * per_chunk], "<i2")
                                  for o in offsets])
    return video, pcm


def jpeg90(image: np.ndarray) -> bytes:
    return cv2.imencode(".jpg", image, [int(cv2.IMWRITE_JPEG_QUALITY), 90])[1].tobytes()


# ---- the MP4 writer -----------------------------------------------------------------

def _mux_both(script) -> tuple[bytes, bytes]:
    out = []
    for mod in (mp4, jmp4):
        f = io.BytesIO()
        script(mod, f)
        out.append(f.getvalue())
    return out[0], out[1]


def _frames(n: int, h: int = 24, w: int = 32, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _script_box_layout(mod, f):
    w = mod.MP4Writer(f, 32, 24, fps=25.0, sample_rate=16000)
    for i, img in enumerate(_frames(7)):
        w.write_video(img)
        w.write_audio(np.full(320, 100 * i, np.int16))
        w.write_audio(np.ones(320, np.float32) * 0.25)
    w.close()


def _script_reblock(mod, f):
    w = mod.MP4Writer(f, 16, 16)
    w.write_video(np.zeros((16, 16, 3), np.uint8))
    w.write_audio(np.arange(500, dtype=np.int16))      # 1 chunk + 180 left
    w.write_audio(np.arange(100, dtype=np.int16))      # 280 left
    w.write_audio(np.linspace(-1.5, 1.5, 77).astype(np.float32))   # clipped floats
    w.close()                                           # a zero-padded tail


def _script_video_only(mod, f):
    w = mod.MP4Writer(f, 40, 30, fps=30.0)
    for img in _frames(3, 30, 40, seed=1):
        w.write_video(img)
    w.close()
    w.close()                                           # a second close writes nothing


def _script_audio_only(mod, f):
    w = mod.MP4Writer(f, 8, 8, sample_rate=8000)
    w.write_audio(np.random.default_rng(2).integers(-3000, 3000, 999).astype(np.int16))
    w.close()


@pytest.mark.parametrize("script", [_script_box_layout, _script_reblock, _script_video_only,
                                    _script_audio_only], ids=lambda s: s.__name__[8:])
def test_mp4_writer_bytes_equal_jax(script):
    port, ref = _mux_both(script)
    assert port == ref and len(port) > 100
    assert [t for t, _, _ in mp4.parse_boxes(port)] == [b"ftyp", b"free", b"mdat", b"moov"]


def test_mp4_samples_read_back():
    """The box-layout stream read back: seven JPEGs of the frames at quality
    90, and the PCM (floats scaled to int16) chunk by chunk."""
    port, _ = _mux_both(_script_box_layout)
    video, pcm = mp4_samples(port)
    assert video == [jpeg90(img) for img in _frames(7)]
    want = np.concatenate([np.r_[np.full(320, 100 * i), np.full(320, 8192)] for i in range(7)])
    np.testing.assert_array_equal(pcm, want)
    _, pcm = mp4_samples(_mux_both(_script_reblock)[0])
    assert len(pcm) == 3 * 320 and (pcm[:500] == np.arange(500)).all()
    assert (pcm[500 + 100 + 77:] == 0).all()


def test_mp4_4gib_recording_bytes_equal_jax(tmp_path):
    """Past 4 GiB (a sparse file): the `free` box becomes the 64-bit mdat
    header and stco becomes co64, byte-equal to JAX's on every written
    region."""
    paths = {}
    for name, mod in (("port", mp4), ("jax", jmp4)):
        p = tmp_path / f"{name}.mp4"
        with open(p, "w+b") as f:
            w = mod.MP4Writer(f, 16, 16, fps=25.0, sample_rate=16000)
            w.write_video(np.zeros((16, 16, 3), np.uint8))
            w.write_audio(np.zeros(320, np.int16))
            f.seek((1 << 32) + 64)
            w.write_video(np.full((16, 16, 3), 255, np.uint8))
            w.write_audio(np.full(320, 1234, np.int16))
            w.close()
        paths[name] = p
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    assert sizes["port"] == sizes["jax"] > 1 << 32
    regions = [(0, 4096), ((1 << 32) + 64, sizes["port"] - (1 << 32) - 64)]
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        for start, n in regions:
            a.seek(start)
            b.seek(start)
            assert a.read(n) == b.read(n)
        a.seek((1 << 32) + 64)
        tail = a.read()
    assert b"co64" in tail and b"stco" not in tail


def test_parse_boxes_matches_jax():
    port, _ = _mux_both(_script_box_layout)
    assert list(mp4.parse_boxes(port)) == list(jmp4.parse_boxes(port))
    moov = _children(port, 0, len(port))[b"moov"]
    assert list(mp4.parse_boxes(port, *moov)) == list(jmp4.parse_boxes(port, *moov))
    for bad in (port + b"\x00\x00\x00", port[:-5], b"\x00\x00\x00\x04free"):
        with pytest.raises(ValueError):
            list(mp4.parse_boxes(bad))
        with pytest.raises(ValueError):
            list(jmp4.parse_boxes(bad))


# ---- BaseReal's recorder ------------------------------------------------------------

def _jax_record_thread(engine) -> threading.Thread:
    return next(t for t in threading.enumerate()
                if getattr(t, "_target", None) == engine._record_loop)


def _record_both(tmp_path, suffix: str, n: int = 6, hw=(24, 32)):
    """The same n frames and 2n chunks queued into the port's and JAX's
    BaseReal recording to ``suffix``; both recorders drained, stopped and
    joined. Returns (port path, JAX path, frames, chunks)."""
    frames = _frames(n, *hw, seed=3)
    rng = np.random.default_rng(4)
    chunks = [rng.integers(-20000, 20000, 320).astype(np.int16) for _ in range(2 * n)]
    engines = {"port": BaseReal(Config().override(**{"tts.backend": "procedural"})),
               "jax": JBaseReal(JConfig().override(**{"tts.backend": "procedural"}))}
    paths = {}
    for name, eng in engines.items():
        video_t, audio_t = (VideoImage, AudioChunk) if name == "port" else (JVideoImage,
                                                                           JAudioChunk)
        paths[name] = str(tmp_path / f"{name}{suffix}")
        eng.start_recording(paths[name])
        thread = eng.record_thread if name == "port" else _jax_record_thread(eng)
        for i, img in enumerate(frames):
            eng.record_video_frame(video_t(image=img))
            for c in chunks[2 * i:2 * i + 2]:
                eng.record_audio_chunk(audio_t(samples=c))
        deadline = time.monotonic() + 30
        while not (eng.recordq_video.empty() and eng.recordq_audio.empty()):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        eng.stop_recording()
        thread.join(timeout=10)
        assert not thread.is_alive()
    return paths["port"], paths["jax"], frames, chunks


def test_base_real_records_an_mp4_equal_to_jax(tmp_path):
    port, ref, frames, chunks = _record_both(tmp_path, ".mp4")
    data = open(port, "rb").read()
    assert data == open(ref, "rb").read()
    assert [t for t, _, _ in mp4.parse_boxes(data)] == [b"ftyp", b"free", b"mdat", b"moov"]
    video, pcm = mp4_samples(data)
    assert video == [jpeg90(f) for f in frames]
    np.testing.assert_array_equal(pcm, np.concatenate(chunks))


def test_base_real_records_an_flv_equal_to_jax(tmp_path):
    port, ref, frames, chunks = _record_both(tmp_path, ".flv")
    data = open(port, "rb").read()
    assert data == open(ref, "rb").read()
    tags = read_flv_tags(data)
    assert [t for t, _, _ in tags].count(8) == len(chunks)
    video = [body for t, _, body in tags if t == 9]
    assert len(video) == len(frames)
    prev = None
    for body, img in zip(video, frames):      # Screen Video is lossless
        prev = decode_screen_video(body[1:], prev)
        np.testing.assert_array_equal(prev, img)


def test_base_real_records_split_files_equal_to_jax(tmp_path, monkeypatch):
    """.split.mp4: the wav equal to JAX's and to the chunks, the MPEG-4 video
    decoding to as many frames as JAX's; with no ffmpeg on the PATH both
    keep the two files."""
    monkeypatch.setenv("PATH", "")
    port, ref, frames, chunks = _record_both(tmp_path, ".split.mp4", hw=(64, 96))
    names = {}
    for name, path in (("port", port), ("jax", ref)):
        base = path[: -len(".split.mp4")] + ".mp4"
        names[name] = (base + ".video.mp4", base + ".audio.wav")
        assert os.path.exists(names[name][0]) and not os.path.exists(base)
    assert open(names["port"][1], "rb").read() == open(names["jax"][1], "rb").read()
    with wave.open(names["port"][1]) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 16000)
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_array_equal(pcm, np.concatenate(chunks))
    decoded = {}
    for name, (video, _) in names.items():
        cap = cv2.VideoCapture(video)
        decoded[name] = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            decoded[name].append(img)
        cap.release()
    assert len(decoded["port"]) == len(decoded["jax"]) == len(frames)
    for a, b in zip(decoded["port"], decoded["jax"]):
        np.testing.assert_array_equal(a, b)


class _ClosedWriter:
    """A cv2.VideoWriter that did not open (no MPEG-4 encoder in the build):
    ``write`` does nothing, as OpenCV's does on a writer that is not open."""

    writes = 0

    def __init__(self, *a, **kw):
        pass

    def isOpened(self) -> bool:
        return False

    def write(self, _img) -> None:
        type(self).writes += 1

    def release(self) -> None:
        pass


def test_split_refuses_a_writer_that_did_not_open_where_jax_writes_nothing(tmp_path,
                                                                         monkeypatch):
    """JAX's .split.mp4 recorder never asks ``isOpened()``: with a writer
    that did not open it 'records' on, writing into nothing, and says
    nothing. The port's ends the recording with ``record_error`` set and
    leaves no files."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cv2, "VideoWriter", _ClosedWriter)
    img = np.zeros((16, 16, 3), np.uint8)
    jeng = JBaseReal(JConfig().override(**{"tts.backend": "procedural"}))
    jpath = str(tmp_path / "jax.split.mp4")
    jeng.start_recording(jpath)
    jthread = _jax_record_thread(jeng)
    for _ in range(3):
        jeng.record_video_frame(JVideoImage(image=img))
    deadline = time.monotonic() + 10
    while _ClosedWriter.writes < 3:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert jeng.recording and not os.path.exists(str(tmp_path / "jax.mp4.video.mp4"))
    jeng.stop_recording()
    jthread.join(timeout=10)

    eng = BaseReal(Config().override(**{"tts.backend": "procedural"}))
    path = str(tmp_path / "port.split.mp4")
    eng.start_recording(path)
    eng.record_video_frame(VideoImage(image=img))
    eng.record_thread.join(timeout=10)
    assert not eng.record_thread.is_alive() and not eng.recording
    assert "did not open" in eng.record_error
    assert not any(p.name.startswith("port") for p in tmp_path.iterdir())
    eng.start_recording(str(tmp_path / "again.mp4"))     # a later recording starts clean
    assert eng.record_error is None
    eng.stop_recording()
    eng.record_thread.join(timeout=10)


def test_stop_drops_what_is_still_queued(tmp_path, monkeypatch):
    """Matched on purpose: at stop the recorder finishes the frame it holds
    and drops the frames still queued, as JAX's does; the file is whole."""
    held, release = threading.Event(), threading.Event()
    real = mp4.MP4Writer.write_video

    def slow_write(self, image):
        held.set()
        release.wait(10)
        real(self, image)

    monkeypatch.setattr(mp4.MP4Writer, "write_video", slow_write)
    eng = BaseReal(Config().override(**{"tts.backend": "procedural"}))
    path = str(tmp_path / "drop.mp4")
    eng.start_recording(path)
    for img in _frames(5, seed=6):
        eng.record_video_frame(VideoImage(image=img))
        for _ in range(2):
            eng.record_audio_chunk(AudioChunk(samples=np.ones(320, np.int16)))
    assert held.wait(10)
    eng.stop_recording()
    release.set()
    eng.record_thread.join(timeout=10)
    video, pcm = mp4_samples(open(path, "rb").read())
    assert len(video) == 1 and len(pcm) == 640
    assert eng.recordq_video.qsize() == 4 and eng.recordq_audio.qsize() == 8


def test_a_restart_leaves_the_last_recorder_its_own_file(tmp_path, monkeypatch):
    """A stop, then a start while the last recorder still writes its frame:
    that recorder closes its own file (its stop event is set) and the new
    one records the new frames. JAX's recorders share one flag, so the old
    thread would go on draining the new recording's queues into the old
    file, which it would not close. The queues stay shared: the old
    recorder may still take up to two chunks, its last frame's, from the
    new recording's (which ones depends on which thread runs first)."""
    held, release = threading.Event(), threading.Event()
    real = mp4.MP4Writer.write_video

    def first_write_waits(self, image):
        if not held.is_set():
            held.set()
            release.wait(10)
        real(self, image)

    monkeypatch.setattr(mp4.MP4Writer, "write_video", first_write_waits)
    eng = BaseReal(Config().override(**{"tts.backend": "procedural"}))
    frames = _frames(4, seed=8)
    eng.start_recording(str(tmp_path / "a.mp4"))
    first = eng.record_thread
    eng.record_video_frame(VideoImage(image=frames[0]))
    assert held.wait(10)
    eng.stop_recording()
    eng.start_recording(str(tmp_path / "b.mp4"))
    for img in frames[1:]:
        eng.record_video_frame(VideoImage(image=img))
        for _ in range(2):
            eng.record_audio_chunk(AudioChunk(samples=np.ones(320, np.int16)))
    release.set()
    first.join(timeout=10)
    deadline = time.monotonic() + 10
    while not eng.recordq_video.empty():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    eng.stop_recording()
    eng.record_thread.join(timeout=10)
    a, pcm_a = mp4_samples(open(tmp_path / "a.mp4", "rb").read())
    b, pcm_b = mp4_samples(open(tmp_path / "b.mp4", "rb").read())
    assert a == [jpeg90(frames[0])] and len(pcm_a) in (0, 320, 640)
    assert b == [jpeg90(f) for f in frames[1:]]
    assert len(pcm_a) + len(pcm_b) == 6 * 320


def test_start_recording_twice_keeps_one_recorder(tmp_path):
    eng = BaseReal(Config().override(**{"tts.backend": "procedural"}))
    eng.start_recording(str(tmp_path / "a.mp4"))
    first = eng.record_thread
    eng.start_recording(str(tmp_path / "b.mp4"))
    assert eng.record_thread is first and not os.path.exists(tmp_path / "b.mp4")
    eng.stop_recording()
    first.join(timeout=10)
    assert not eng.recording and os.path.exists(tmp_path / "a.mp4")


# ---- sessions -------------------------------------------------------------------------

class QueueTap:
    """What an engine put into its recorder's queues, in order."""

    def __init__(self, engine):
        self.frames, self.chunks = [], []
        for q, out in ((engine.recordq_video, self.frames), (engine.recordq_audio, self.chunks)):
            put = q.put
            q.put = lambda item, *a, _put=put, _out=out, **kw: (_out.append(item), _put(item))


def test_lip_session_records_frames_and_audio(tmp_path):
    """A Wav2Lip session on the CPU told to speak while recording: every
    video sample written is the JPEG (quality 90) of a frame the session
    queued, in order; the PCM is the queued chunks, speech among them."""
    avatar = synthesize_avatar(str(tmp_path / "avatar"), n_frames=6)
    cfg = Config().override(**{"avatar.batch_size": 2, "tts.backend": "procedural",
                               "avatar.dtype": "float32"})
    engine = LipReal(cfg, avatar=avatar, device=CPU)
    tap = QueueTap(engine)
    path = str(tmp_path / "lip.mp4")

    async def main():
        loop = asyncio.get_running_loop()
        video_track = SimpleNamespace(_queue=asyncio.Queue())
        audio_track = SimpleNamespace(_queue=asyncio.Queue())
        quit_event = threading.Event()
        t = threading.Thread(target=engine.render,
                             args=(quit_event, loop, audio_track, video_track), daemon=True)
        t.start()
        engine.start_recording(path)
        engine.put_msg_txt("the port records what it says")
        try:
            while len(tap.frames) < 24:
                await asyncio.wait_for(video_track._queue.get(), timeout=120)
        finally:
            engine.stop_recording()
            quit_event.set()
            t.join(timeout=10)
        assert not t.is_alive()

    asyncio.run(main())
    engine.record_thread.join(timeout=10)
    video, pcm = mp4_samples(open(path, "rb").read())
    assert 12 <= len(video) <= len(tap.frames)
    assert video == [jpeg90(f.image) for f in tap.frames[:len(video)]]
    assert len(pcm) % 320 == 0 and len(pcm) >= 640 * (len(video) - 1)
    want = np.concatenate([c.samples for c in tap.chunks[:len(pcm) // 320]])
    np.testing.assert_array_equal(pcm, want)
    assert (pcm != 0).any(), "the speech must be in the recording"


NERF_OVERRIDES = {
    "tts.backend": "procedural", "avatar.kind": "ernerf", "transport.mode": "loopback",
    "nerf.grid_size": 16, "nerf.num_levels": 4, "nerf.base_resolution": 16,
    "nerf.desired_resolution": 64, "nerf.log2_hashmap_size": 10, "nerf.max_steps": 8,
    "nerf.scale": 1.0, "server.max_sessions": 1,
}


@pytest.mark.parametrize("suffix", [".mp4", ".flv"])
def test_nerf_session_records_through_the_route(tmp_path, suffix):
    """An ER-NeRF session (K2's plain version on the CPU) recorded through
    POST /record: both tracks, two 20 ms chunks a frame."""
    data_dir = synthesize_nerf_dataset(str(tmp_path / "nerf"), hw=64)
    cfg = Config().override(**NERF_OVERRIDES, **{
        "nerf.pose_path": f"{data_dir}/transforms.json", "nerf.au_path": f"{data_dir}/au.csv"})
    engines = []

    def factory(c, **kw):
        engines.append(make_engine(c, **kw))
        return engines[-1]

    path = str(tmp_path / f"nerf{suffix}")

    async def main():
        client = TestClient(TestServer(create_app(cfg, factory, devices=[CPU])))
        await client.start_server()
        try:
            sid = (await (await client.post("/start_session", json={})).json())["session_id"]
            written = metrics.latency("record.frame").count
            body = await (await client.post("/record", json={
                "session_id": sid, "type": "start_record", "path": path})).json()
            assert body["code"] == 0, body
            await client.post("/talk", json={"session_id": sid, "type": "echo",
                                              "text": "the nerf port is recorded"})
            deadline = time.monotonic() + 120
            while metrics.latency("record.frame").count < written + 6:
                assert time.monotonic() < deadline, "nothing recorded"
                await asyncio.sleep(0.05)
            body = await (await client.post("/record", json={
                "session_id": sid, "type": "end_record"})).json()
            assert body["code"] == 0
            engines[0].record_thread.join(timeout=10)
            await client.post("/stop_session", json={"session_id": sid})
        finally:
            await client.close()

    asyncio.run(main())
    data = open(path, "rb").read()
    if suffix == ".mp4":
        video, pcm = mp4_samples(data)
        assert len(video) >= 6 and len(pcm) >= 640 * (len(video) - 1)
        img = cv2.imdecode(np.frombuffer(video[0], np.uint8), cv2.IMREAD_COLOR)
        assert img.shape == (64, 64, 3)
    else:
        kinds = [t for t, _, _ in read_flv_tags(data)]
        assert kinds.count(9) >= 6 and kinds.count(8) >= 2 * (kinds.count(9) - 1)


def test_put_res_frame_gives_up_once_the_session_quits(tmp_path):
    """The inference thread's frames go to a bounded queue that only the
    assembly thread drains, and that thread ends with the session: a full
    queue once the session quits drops the frame instead of blocking the
    inference thread (its engine and device buffers) for good."""
    avatar = synthesize_avatar(str(tmp_path / "avatar"), n_frames=4)
    cfg = Config().override(**{"avatar.batch_size": 2, "tts.backend": "procedural",
                               "avatar.dtype": "float32"})
    engine = LipReal(cfg, avatar=avatar, device=CPU)
    quit_event = threading.Event()
    while not engine.res_frame_queue.full():
        assert engine.put_res_frame((None, 0, []), quit_event)
    threading.Timer(0.3, quit_event.set).start()
    t0 = time.monotonic()
    assert engine.put_res_frame((None, 1, []), quit_event) is False
    assert 0.25 < time.monotonic() - t0 < 5
    engine.res_frame_queue.get()
    assert engine.put_res_frame((None, 2, []), quit_event) is True
