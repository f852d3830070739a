"""Socket streaming-ASR server over the fixed line-packet protocol.

Equivalent of the reference's whisper_online_server.py socket mode: clients
stream raw PCM16 bytes; committed transcript segments are sent back as
'beg_ms end_ms text' lines (the MLTB/ELITR contract).

Port of mere_fusion_tpu/asr/server.py over the port's
``transport/line_packet.py``, whose receiver reads whole packets.
"""
from __future__ import annotations

import logging
import socket

import numpy as np

from mere_fusion_tpu_torch.transport.line_packet import send_one_line

logger = logging.getLogger(__name__)

CHUNK_BYTES = 65536


def handle_connection(conn: socket.socket, transcriber,
                      min_chunk_seconds: float = 1.0,
                      sample_rate: int = 16000) -> None:
    pending: list[np.ndarray] = []
    pending_n = 0
    min_samples = int(min_chunk_seconds * sample_rate)
    leftover = b""
    while True:
        data = conn.recv(CHUNK_BYTES)
        if not data:
            break
        buf = leftover + data
        usable = len(buf) - (len(buf) % 2)
        leftover = buf[usable:]
        pcm = np.frombuffer(buf[:usable], np.int16).astype(np.float32) / 32768.0
        pending.append(pcm)
        pending_n += len(pcm)
        if pending_n < min_samples:
            continue
        transcriber.insert_audio_chunk(np.concatenate(pending))
        pending, pending_n = [], 0
        beg, end, text = transcriber.process_iter()
        if text:
            send_one_line(conn, f"{int(beg * 1000)} {int(end * 1000)} {text}")
    beg, end, text = transcriber.finish()
    if text:
        try:
            send_one_line(conn, f"{int((beg or 0) * 1000)} {int((end or 0) * 1000)} {text}")
        except OSError:
            pass


def serve(host: str, port: int, make_transcriber) -> None:
    """Accept loop: one transcriber per connection (per-session state —
    unlike the reference, which reuses one OnlineASRProcessor for all
    connections, whisper_online_server.py:34)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(1)
        logger.info("ASR socket server on %s:%d", host, port)
        while True:
            conn, addr = s.accept()
            logger.info("connection from %s", addr)
            with conn:
                handle_connection(conn, make_transcriber())
