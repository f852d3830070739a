"""Word-level timestamps from cross-attention DTW.

A copy of mere_fusion_tpu/asr/align.py (host code over the decoder's
cross-attention weights, read back from the device).

Host-side analog of openai-whisper's timing.py find_alignment (the vendored
reference copy exposes encoder embeddings only; faster-whisper gets word
timestamps from CTranslate2): the decoder's cross-attention over the final
token sequence is averaged over the upper-half layers' heads, median-
filtered along audio time, and a monotone DTW path assigns each token an
encoder frame (20 ms); tokens merge into words at tokenizer word starts.
"""
from __future__ import annotations

import numpy as np

ENC_FRAME_SECONDS = 0.02     # whisper encoder frame = 2 mel hops = 20 ms


def median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last axis with edge padding."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    stack = np.stack([xp[..., i:i + x.shape[-1]] for i in range(width)], -1)
    return np.median(stack, axis=-1)


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotone DTW through cost [N_text, T_audio]; steps (1,0),(0,1),(1,1).
    Returns (text_idx, time_idx) arrays along the optimal path."""
    n, t = cost.shape
    acc = np.full((n + 1, t + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, t + 1), np.int8)
    for i in range(1, n + 1):
        row = cost[i - 1]
        for j in range(1, t + 1):
            c0, c1, c2 = acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]
            m = min(c0, c1, c2)
            acc[i, j] = row[j - 1] + m
            trace[i, j] = 0 if m == c0 else (1 if m == c1 else 2)
    i, j = n, t
    ti, tj = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        s = trace[i, j]
        if s == 0:
            i, j = i - 1, j - 1
        elif s == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(tj[::-1])


def token_times(attn: np.ndarray, n_prompt: int, n_frames: int,
                filter_width: int = 7) -> np.ndarray:
    """attn [n_layers, B=1, h, L_tokens, T'] → start time (s) per generated
    token [L_tokens - n_prompt]. n_frames limits audio time to the real
    (unpadded) segment."""
    nl = attn.shape[0]
    w = attn[nl // 2:, 0]                       # upper-half layers [l,h,L,T]
    w = w.reshape(-1, *w.shape[2:]).mean(0)     # [L, T]
    w = w[:, :max(n_frames, 1)]
    std = w.std() + 1e-6
    w = (w - w.mean()) / std
    w = median_filter(w, filter_width)
    text = w[n_prompt:]
    if text.shape[0] == 0:
        return np.zeros((0,), np.float32)
    ti, tj = dtw_path(-text)
    starts = np.zeros(text.shape[0], np.float32)
    seen = set()
    for a, b in zip(ti, tj):
        if a not in seen:
            seen.add(a)
            starts[a] = b * ENC_FRAME_SECONDS
    return starts


def words_with_times(tokens: list[int], starts: np.ndarray, tokenizer,
                     seg_end: float) -> list[tuple[float, float, str]]:
    """Merge per-token start times into (start, end, word) triples. Words
    begin at tokens whose decoded text starts with a space (byte-level BPE)
    or at the first token."""
    words: list[tuple[float, float, str]] = []
    cur_text, cur_start = "", 0.0
    for i, (tok, st) in enumerate(zip(tokens, starts)):
        piece = tokenizer.decode([tok])
        if i > 0 and piece.startswith(" ") and cur_text.strip():
            words.append((cur_start, float(st), cur_text.strip()))
            cur_text, cur_start = piece, float(st)
        else:
            if not cur_text:
                cur_start = float(st)
            cur_text += piece
    if cur_text.strip():
        words.append((cur_start, float(seg_end), cur_text.strip()))
    # enforce monotone non-crossing boundaries
    out = []
    prev_end = 0.0
    for s, e, t in words:
        s = max(s, prev_end)
        e = max(e, s)
        out.append((s, e, t))
        prev_end = e
    return out
