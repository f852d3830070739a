"""Build native sources into the package's gitignored build directory.

Every library is named after a hash of its sources and compiler command, so
a changed source rebuilds and an unchanged one loads the cached file. The
output is written to a temporary name and renamed into place, so concurrent
builds never load a half-written library. Builds of different libraries run
in parallel (one lock per output file).
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")

_locks: dict[str, threading.Lock] = {}
_locks_lock = threading.Lock()


def build_shared(name: str, sources: list[str], command: list[str],
                 timeout: float = 600.0, headers: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` with ``command + ["-o", out] + sources`` into
    ``_build/lib<name>-<hash>.so`` unless it is already there; returns the
    path. ``headers`` are files the sources include: they are hashed with
    them. The compiler's output goes beside it as ``.log``. Raises
    RuntimeError with that output on failure."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in (*sources, *headers):
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    with _locks_lock:
        lock = _locks.setdefault(out, threading.Lock())
    with lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(command + ["-o", tmp] + sources,
                              capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(command)}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return out
