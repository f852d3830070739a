"""ctypes bindings for the native host library (native/mfhost.cpp).

Builds the repo's ``native/mfhost.cpp`` into the port's build directory on
first use if g++ is available; every entry point has a numpy fallback so
the framework runs without a compiler. Host code: frame blending and PCM
conversion on the CPU side of the pipeline.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from mere_fusion_tpu_torch.runtime.build import build_shared

_SRC = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "..", "..", "native", "mfhost.cpp"))

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    try:
        path = build_shared("mfhost", [_SRC],
                            ["g++", "-O3", "-shared", "-fPIC"],
                            timeout=120)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    i64, f32p, i16p, u8p = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8),
    )
    lib.f32_to_pcm16.argtypes = [f32p, i16p, i64]
    lib.f32_to_pcm16.restype = None
    lib.pcm16_to_f32.argtypes = [i16p, f32p, i64]
    lib.pcm16_to_f32.restype = None
    lib.blend_linear_u8.argtypes = [u8p, u8p, f32p, u8p, i64, i64, i64]
    lib.blend_linear_u8.restype = None
    lib.paste_u8.argtypes = [u8p, u8p] + [i64] * 7
    lib.paste_u8.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)
    out = np.empty(x.shape, np.int16)
    lib.f32_to_pcm16(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_int16), x.size)
    return out


def pcm16_to_f32(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    lib = _load()
    if lib is None:
        return x.astype(np.float32) / 32768.0
    out = np.empty(x.shape, np.float32)
    lib.pcm16_to_f32(_ptr(x, ctypes.c_int16), _ptr(out, ctypes.c_float), x.size)
    return out


def blend_linear_u8(fg: np.ndarray, bg: np.ndarray, w: np.ndarray) -> np.ndarray:
    """out = fg·w + bg·(1−w); fg/bg [H,W,C] u8, w [H,W] float32."""
    lib = _load()
    if lib is None:
        wf = w[..., None].astype(np.float32)
        return (fg * wf + bg * (1 - wf) + 0.5).astype(np.uint8)
    fg = np.ascontiguousarray(fg, np.uint8)
    bg = np.ascontiguousarray(bg, np.uint8)
    w = np.ascontiguousarray(w, np.float32)
    if bg.shape != fg.shape or w.shape != fg.shape[:2]:
        raise ValueError(f"blend shapes differ: {fg.shape} {bg.shape} {w.shape}")
    out = np.empty_like(fg)
    h, width, c = fg.shape
    lib.blend_linear_u8(
        _ptr(fg, ctypes.c_uint8), _ptr(bg, ctypes.c_uint8),
        _ptr(w, ctypes.c_float), _ptr(out, ctypes.c_uint8), h, width, c,
    )
    return out


def paste_u8(src: np.ndarray, dst: np.ndarray, y: int, x: int) -> None:
    """Copy src into dst (in place) at (y, x) with bounds clipping."""
    lib = _load()
    if lib is None:
        sh, sw = src.shape[:2]
        dh, dw = dst.shape[:2]
        y0, x0 = max(0, y), max(0, x)
        y1, x1 = min(dh, y + sh), min(dw, x + sw)
        if y1 > y0 and x1 > x0:
            dst[y0:y1, x0:x1] = src[y0 - y : y1 - y, x0 - x : x1 - x]
        return
    src = np.ascontiguousarray(src, np.uint8)
    if not dst.flags.c_contiguous or dst.dtype != np.uint8:
        raise ValueError("paste_u8 needs a C-contiguous uint8 destination")
    sh, sw, c = src.shape
    dh, dw, _ = dst.shape
    lib.paste_u8(
        _ptr(src, ctypes.c_uint8), _ptr(dst, ctypes.c_uint8),
        sh, sw, dh, dw, y, x, c,
    )
