"""Standalone byte-level BPE codec (GPT-2 style) for Whisper tokenizers.

A copy of mere_fusion_tpu/utils/bpe.py (pure Python).

The reference builds its tokenizer through transformers from vendored asset
files (reference: musetalk/whisper/whisper/tokenizer.py, assets/multilingual/
vocab.json + merges.txt). This is a dependency-free implementation of the
same published algorithm: byte→unicode remapping, greedy pair merging with a
learned merge ranking, and special-token handling. Decode-only use needs just
vocab.json.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Iterable


@functools.lru_cache()
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte↔unicode mapping (printable chars stay put)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_SPLIT_PATTERN = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\d\W]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+""",
    re.UNICODE,
)


class BPETokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 special_tokens: dict[str, int] | None = None):
        self.encoder = dict(vocab)
        self.special = dict(special_tokens or {})
        self.encoder.update(self.special)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        b2u = _byte_to_unicode()
        self.b2u = b2u
        self.u2b = {c: b for b, c in b2u.items()}

    @classmethod
    def from_assets(cls, assets_dir: str) -> "BPETokenizer":
        """Load vocab.json + merges.txt (+ added_tokens.json) from a
        directory in the published GPT-2/whisper layout."""
        with open(os.path.join(assets_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        merges_path = os.path.join(assets_dir, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#version"):
                        continue
                    a, _, b = line.partition(" ")
                    merges.append((a, b))
        special = {}
        added = os.path.join(assets_dir, "added_tokens.json")
        if os.path.exists(added):
            with open(added, encoding="utf-8") as f:
                special = json.load(f)
        return cls(vocab, merges, special)

    # ---- encode ---------------------------------------------------------------
    def _bpe(self, token: str) -> list[str]:
        parts = list(token)
        while len(parts) > 1:
            best = None
            best_rank = None
            for pair in zip(parts[:-1], parts[1:]):
                rank = self.ranks.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = pair, rank
            if best is None:
                break
            merged = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return parts

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _SPLIT_PATTERN.findall(text):
            mapped = "".join(self.b2u[b] for b in word.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    # ---- decode ---------------------------------------------------------------
    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        out: list[str] = []
        for i in ids:
            tok = self.decoder.get(int(i))
            if tok is None:
                continue
            if tok in self.special:
                if not skip_special:
                    out.append(tok)
                continue
            out.append(tok)
        text = "".join(out)
        data = bytes(self.u2b.get(c, ord("?")) for c in text)
        return data.decode("utf-8", errors="replace")


# the reference checkout's layout, relative to the working directory
DEFAULT_MULTILINGUAL_ASSETS = os.path.join(
    "musetalk", "whisper", "whisper", "assets", "multilingual")


def load_whisper_tokenizer(assets_dir: str | None = None) -> BPETokenizer:
    """The whisper tokenizer from ``assets_dir``, else from the directory
    that WHISPER_TOKENIZER_ASSETS names, else DEFAULT_MULTILINGUAL_ASSETS;
    raises FileNotFoundError when it holds no vocab.json."""
    assets_dir = assets_dir or os.environ.get(
        "WHISPER_TOKENIZER_ASSETS", DEFAULT_MULTILINGUAL_ASSETS
    )
    return BPETokenizer.from_assets(assets_dir)
