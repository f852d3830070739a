"""Fixed-size socket line protocol (ELITR legacy).

Port of mere_fusion_tpu/transport/line_packet.py (reference:
line_packet.py:15-60): each line goes as one zero-padded PACKET_SIZE buffer
of UTF-8 text; short lines may share a packet, separated by newlines.
"""
from __future__ import annotations

PACKET_SIZE = 65536


def send_one_line(socket, text: str) -> None:
    """Send the first line of ``text`` (newline appended, zero-padded to
    PACKET_SIZE); a NUL counts as a line break."""
    lines = text.replace("\0", "\n").splitlines()
    data = ((lines[0] if lines else "") + "\n").encode("utf-8")[:PACKET_SIZE]
    socket.sendall(data.ljust(PACKET_SIZE, b"\0"))


def receive_one_line(socket) -> str | None:
    """Receive one whole packet: its text up to the first NUL, or None when
    the connection closed. The JAX package stops at the first chunk that
    holds a NUL, which leaves the rest of the packet's padding to be read as
    the next line when recv returns part of a packet; this reads all
    PACKET_SIZE bytes (ROADMAP §3)."""
    received = bytearray()
    while len(received) < PACKET_SIZE:
        chunk = socket.recv(PACKET_SIZE - len(received))
        if not chunk:
            return None
        received += chunk
    return bytes(received).split(b"\0", 1)[0].decode("utf-8", errors="replace")


def receive_lines(socket) -> list[str] | None:
    text = receive_one_line(socket)
    if text is None:
        return None
    return [ln for ln in text.split("\n") if ln]
