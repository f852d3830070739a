"""ISO-BMFF (MP4) muxing in Python: MJPEG video and PCM16 audio.

Port of mere_fusion_tpu/transport/mp4.py; for the same frames and audio it
writes the same bytes. A session's recording is one self-contained MP4
whose codecs Python can encode and stock players decode:

- video: Motion-JPEG. Every sample is a baseline JPEG (``cv2.imencode``),
  carried in an ``mp4v`` VisualSampleEntry whose ``esds`` declares
  objectTypeIndication 0x6C (ISO/IEC 10918-1 JPEG, ISO 14496-1 table 5).
  Every sample is a sync sample, so ``stss`` is left out (ISO 14496-12
  §8.6.2: its absence means all-sync).
- audio: little-endian PCM16 mono in a QuickTime ``sowt`` AudioSampleEntry
  (version 0, sampleSize 16), which ffmpeg's mov demuxer maps to
  pcm_s16le. The PCM sample tables follow QuickTime: stsz a constant 2
  bytes a sample, stts delta 1, a fixed number of samples a chunk in stsc.

Layout: ``ftyp``, a streamed ``mdat`` (its size written back on close, so
the file must be seekable), then ``moov`` with the full sample tables.
"""
from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
VIDEO_TIMESCALE = 90000
MOVIE_TIMESCALE = 1000


def _box(typ: bytes, *payload: bytes) -> bytes:
    data = b"".join(payload)
    return struct.pack(">I", 8 + len(data)) + typ + data


def _full(typ: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(typ, struct.pack(">I", (version << 24) | flags), *payload)


def _descr(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with minimal-length size encoding (<2^28)."""
    n = len(payload)
    size = b""
    for shift in (21, 14, 7):
        if n >= (1 << shift):
            size += bytes([0x80 | ((n >> shift) & 0x7F)])
    return bytes([tag]) + size + bytes([n & 0x7F]) + payload


def _esds_jpeg() -> bytes:
    """ES descriptor declaring OTI 0x6C (JPEG) visual stream."""
    dcd = _descr(0x04, struct.pack(">BBBHII", 0x6C, (0x04 << 2) | 1,
                                   0, 0,          # bufferSizeDB (24-bit) = 0
                                   0, 0))         # max/avg bitrate unknown
    slc = _descr(0x06, b"\x02")
    es = _descr(0x03, struct.pack(">HB", 1, 0) + dcd + slc)
    return _full(b"esds", 0, 0, es)


def _sample_entry_mp4v(width: int, height: int) -> bytes:
    return _box(
        b"mp4v",
        b"\x00" * 6, struct.pack(">H", 1),          # data_reference_index
        b"\x00" * 16,                                # pre_defined/reserved
        struct.pack(">HH", width, height),
        struct.pack(">II", 0x00480000, 0x00480000),  # 72 dpi
        b"\x00" * 4,
        struct.pack(">H", 1),                        # frame_count
        b"\x00" * 32,                                # compressorname
        struct.pack(">Hh", 24, -1),                  # depth, pre_defined
        _esds_jpeg(),
    )


def _sample_entry_sowt(sample_rate: int, channels: int = 1) -> bytes:
    return _box(
        b"sowt",
        b"\x00" * 6, struct.pack(">H", 1),           # data_reference_index
        struct.pack(">HH", 0, 0),                    # version, revision
        b"\x00" * 4,                                 # vendor
        struct.pack(">HHHH", channels, 16, 0, 0),    # chans, bits, cid, pkt
        struct.pack(">I", sample_rate << 16),
    )


def _stbl(entry: bytes, stts: bytes, stsc: bytes, stsz: bytes,
          offsets: list[int]) -> bytes:
    # chunk offsets past 4 GiB need the 64-bit co64 variant (ISO 14496-12
    # §8.7.5) — long recordings (MJPEG reaches 4 GiB in a few hours)
    if offsets and max(offsets) >= 1 << 32:
        stco = _full(b"co64", 0, 0, struct.pack(">I", len(offsets)),
                     struct.pack(f">{len(offsets)}Q", *offsets))
    else:
        stco = _full(b"stco", 0, 0, struct.pack(">I", len(offsets)),
                     struct.pack(f">{len(offsets)}I", *offsets)
                     if offsets else b"")
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
    return _box(b"stbl", stsd, stts, stsc, stsz, stco)


def _minf(media_header: bytes, stbl: bytes) -> bytes:
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1))
    return _box(b"minf", media_header, _box(b"dinf", dref), stbl)


def _tkhd(track_id: int, duration_mv: int, width: int = 0,
          height: int = 0, volume: int = 0) -> bytes:
    return _full(
        b"tkhd", 0, 3,
        struct.pack(">IIII", 0, 0, track_id, 0),
        struct.pack(">I", duration_mv),
        b"\x00" * 8,
        struct.pack(">HHHH", 0, 0, volume, 0),
        _MATRIX,
        struct.pack(">II", width << 16, height << 16),
    )


def _mdhd(timescale: int, duration: int) -> bytes:
    return _full(b"mdhd", 0, 0,
                 struct.pack(">IIIIHH", 0, 0, timescale, duration,
                             0x55C4, 0))  # language "und"


def _hdlr(handler: bytes, name: bytes) -> bytes:
    return _full(b"hdlr", 0, 0, b"\x00" * 4, handler, b"\x00" * 12,
                 name + b"\x00")


class MP4Writer:
    """Stream BGR frames + PCM16 audio into a single .mp4 file.

    Same surface as transport/flv.FLVWriter: ``write_video(bgr_uint8)``,
    ``write_audio(samples)`` (float in [-1, 1] or int16), ``close()``.
    Audio is re-blocked into fixed 20 ms chunks so the PCM sample-to-chunk
    table stays a single stsc entry; a short trailing block is zero-padded.
    """

    def __init__(self, f: BinaryIO, width: int, height: int,
                 fps: float = 25.0, sample_rate: int = 16000,
                 jpeg_quality: int = 90):
        self.f = f
        self.width, self.height = width, height
        self.fps = fps
        self.sample_rate = sample_rate
        self.jpeg_quality = jpeg_quality
        self.chunk_samples = int(round(sample_rate * 0.02))
        self._video_sizes: list[int] = []
        self._video_offsets: list[int] = []
        self._audio_offsets: list[int] = []
        self._audio_total = 0
        self._pcm_rem = np.zeros((0,), np.int16)
        self._closed = False
        f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                     b"isom", b"iso2", b"mp41"))
        # an 8-byte `free` box precedes the mdat header: if the recording
        # grows past 4 GiB, close() rewrites these 16 bytes as a single
        # size=1 + largesize (64-bit) mdat header (ISO 14496-12 §4.2)
        self._free_pos = f.tell()
        f.write(struct.pack(">I", 8) + b"free")
        self._mdat_pos = f.tell()
        f.write(struct.pack(">I", 8) + b"mdat")

    # ---- samples -------------------------------------------------------

    def write_video(self, image_bgr: np.ndarray) -> None:
        import cv2

        ok, enc = cv2.imencode(
            ".jpg", image_bgr,
            [int(cv2.IMWRITE_JPEG_QUALITY), self.jpeg_quality])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        data = enc.tobytes()
        self._video_offsets.append(self.f.tell())
        self._video_sizes.append(len(data))
        self.f.write(data)

    def write_audio(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            samples = np.clip(samples * 32768.0, -32768, 32767
                              ).astype(np.int16)
        pcm = np.concatenate([self._pcm_rem, samples.reshape(-1)])
        n_full = len(pcm) // self.chunk_samples * self.chunk_samples
        for i in range(0, n_full, self.chunk_samples):
            self._write_chunk(pcm[i:i + self.chunk_samples])
        self._pcm_rem = pcm[n_full:]

    def _write_chunk(self, chunk: np.ndarray) -> None:
        self._audio_offsets.append(self.f.tell())
        self._audio_total += len(chunk)
        self.f.write(chunk.astype("<i2").tobytes())

    # ---- finalize --------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if len(self._pcm_rem):
            pad = np.zeros((self.chunk_samples,), np.int16)
            pad[: len(self._pcm_rem)] = self._pcm_rem
            self._write_chunk(pad)
            self._pcm_rem = self._pcm_rem[:0]
        end = self.f.tell()
        if end - self._mdat_pos < 1 << 32:
            self.f.seek(self._mdat_pos)
            self.f.write(struct.pack(">I", end - self._mdat_pos))
        else:
            # >4 GiB: consume the reserved `free` box as a 16-byte
            # size=1 + largesize mdat header; the stale 8-byte 32-bit
            # header becomes opaque payload bytes no sample offset touches
            self.f.seek(self._free_pos)
            self.f.write(struct.pack(">I", 1) + b"mdat"
                         + struct.pack(">Q", end - self._free_pos))
        self.f.seek(end)
        self.f.write(self._moov())
        self.f.flush()

    def _moov(self) -> bytes:
        nv = len(self._video_sizes)
        vdelta = int(round(VIDEO_TIMESCALE / self.fps))
        vdur = nv * vdelta
        adur = self._audio_total
        dur_mv = max(
            int(round(vdur * MOVIE_TIMESCALE / VIDEO_TIMESCALE)),
            int(round(adur * MOVIE_TIMESCALE / self.sample_rate)))

        mvhd = _full(b"mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, dur_mv),
                     struct.pack(">IHH", 0x00010000, 0x0100, 0),
                     b"\x00" * 8, _MATRIX, b"\x00" * 24,
                     struct.pack(">I", 3))

        traks = []
        if nv:
            stts = _full(b"stts", 0, 0, struct.pack(">III", 1, nv, vdelta))
            stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
            stsz = _full(b"stsz", 0, 0,
                         struct.pack(">II", 0, nv),
                         struct.pack(f">{nv}I", *self._video_sizes))
            stbl = _stbl(_sample_entry_mp4v(self.width, self.height),
                         stts, stsc, stsz, self._video_offsets)
            minf = _minf(_full(b"vmhd", 0, 1, b"\x00" * 8), stbl)
            mdia = _box(b"mdia", _mdhd(VIDEO_TIMESCALE, vdur),
                        _hdlr(b"vide", b"VideoHandler"), minf)
            traks.append(_box(b"trak", _tkhd(1, dur_mv, self.width,
                                             self.height), mdia))
        if self._audio_offsets:
            stts = _full(b"stts", 0, 0, struct.pack(">III", 1, adur, 1))
            stsc = _full(b"stsc", 0, 0,
                         struct.pack(">IIII", 1, 1, self.chunk_samples, 1))
            stsz = _full(b"stsz", 0, 0, struct.pack(">II", 2, adur))
            stbl = _stbl(_sample_entry_sowt(self.sample_rate),
                         stts, stsc, stsz, self._audio_offsets)
            minf = _minf(_full(b"smhd", 0, 0, b"\x00" * 4), stbl)
            mdia = _box(b"mdia", _mdhd(self.sample_rate, adur),
                        _hdlr(b"soun", b"SoundHandler"), minf)
            traks.append(_box(b"trak", _tkhd(2, dur_mv, volume=0x0100),
                              mdia))
        return _box(b"moov", mvhd, *traks)


# ---- minimal parser (for tests and sanity checks) ---------------------------

def parse_boxes(data: bytes, start: int = 0, end: int | None = None):
    """Yield (type, payload_start, payload_end) for top-level boxes."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos:pos + 4])[0]
        typ = data[pos + 4:pos + 8]
        payload = pos + 8
        if size == 1:                   # 64-bit largesize (ISO 14496-12 §4.2)
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            payload = pos + 16
        if size < 8 or pos + size > end:
            raise ValueError(f"bad box {typ!r} size {size} at {pos}")
        yield typ, payload, pos + size
        pos += size
    if pos != end:
        raise ValueError(f"trailing {end - pos} bytes after last box")
