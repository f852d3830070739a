"""Transcript normalizers for WER-style comparisons.

Port of mere_fusion_tpu/asr/normalizers.py: plain Python, copied.

Behavioral re-implementation of the vendored Whisper normalizers the
reference ships (reference: musetalk/whisper/whisper/normalizers/basic.py
and english.py) — used when comparing our streaming transcripts against
reference transcripts, where raw strings differ only in case, punctuation,
and contracted forms.

``BasicTextNormalizer`` matches the reference's semantics: bracketed
asides dropped, unicode symbols/punctuation → spaces (optionally with
diacritic stripping via NFKD), lowercase, collapsed whitespace.

``EnglishTextNormalizer`` applies the reference's full pipeline: bracket
and filler removal, contraction/title expansion, digit-comma and period
handling, symbol stripping that preserves numeric punctuation, spelled-out
number rewriting (``numwords.EnglishNumberNormalizer``), British→American
spelling normalization (``spelling.EnglishSpellingNormalizer``), and
whitespace collapse.  Parity with the reference module is asserted
directly in tests/test_normalizers.py (the reference normalizers import
standalone, bypassing the vendored package's ffmpeg-importing __init__).
"""
from __future__ import annotations

import re
import unicodedata

from mere_fusion_tpu_torch.asr.numwords import EnglishNumberNormalizer  # noqa: F401
from mere_fusion_tpu_torch.asr.spelling import EnglishSpellingNormalizer  # noqa: F401

ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Drop diacritic marks (NFKD combining chars) and replace every
    symbol/punctuation codepoint with a space, keeping ``keep`` chars."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in ADDITIONAL_DIACRITICS:
            out.append(ADDITIONAL_DIACRITICS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue          # combining diacritic: drop
            if cat[0] in "MSP":
                out.append(" ")   # symbol/punctuation: space
            else:
                out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Replace symbols/punctuation with spaces; keep diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.clean = (remove_symbols_and_diacritics if remove_diacritics
                      else remove_symbols)
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # <asides> and [asides]
        s = re.sub(r"\(([^)]+?)\)", "", s)        # (asides)
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(s.replace(" ", ""))
        return re.sub(r"\s+", " ", s).strip()


_FILLERS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"

# Ordered rewrite rules; order matters (irregulars and multi-word forms
# must fire before the generic suffix rules at the end).
_REWRITES = (
    # irregular contractions and informal forms
    (r"\bwon't\b", "will not"),
    (r"\bcan't\b", "can not"),
    (r"\blet's\b", "let us"),
    (r"\bain't\b", "aint"),
    (r"\by'all\b", "you all"),
    (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"),
    (r"\bgonna\b", "going to"),
    (r"\bi'ma\b", "i am going to"),
    (r"\bimma\b", "i am going to"),
    (r"\bwoulda\b", "would have"),
    (r"\bcoulda\b", "could have"),
    (r"\bshoulda\b", "should have"),
    (r"\bma'am\b", "madam"),
    # abbreviated titles (the trailing space keeps a following period
    # from gluing to the expansion)
    (r"\bmr\b", "mister "),
    (r"\bmrs\b", "missus "),
    (r"\bst\b", "saint "),
    (r"\bdr\b", "doctor "),
    (r"\bprof\b", "professor "),
    (r"\bcapt\b", "captain "),
    (r"\bgov\b", "governor "),
    (r"\bald\b", "alderman "),
    (r"\bgen\b", "general "),
    (r"\bsen\b", "senator "),
    (r"\brep\b", "representative "),
    (r"\bpres\b", "president "),
    (r"\brev\b", "reverend "),
    (r"\bhon\b", "honorable "),
    (r"\basst\b", "assistant "),
    (r"\bassoc\b", "associate "),
    (r"\blt\b", "lieutenant "),
    (r"\bcol\b", "colonel "),
    (r"\bjr\b", "junior "),
    (r"\bsr\b", "senior "),
    (r"\besq\b", "esquire "),
    # perfect tenses must resolve before the generic 's/'d rules
    (r"'d been\b", " had been"),
    (r"'s been\b", " has been"),
    (r"'d gone\b", " had gone"),
    (r"'s gone\b", " has gone"),
    (r"'d done\b", " had done"),
    (r"'s got\b", " has got"),
    # generic contraction suffixes
    (r"n't\b", " not"),
    (r"'re\b", " are"),
    (r"'s\b", " is"),
    (r"'d\b", " would"),
    (r"'ll\b", " will"),
    (r"'t\b", " not"),
    (r"'ve\b", " have"),
    (r"'m\b", " am"),
)


class EnglishTextNormalizer:
    """Full English transcript normalizer matching the reference pipeline
    (reference: musetalk/whisper/whisper/normalizers/english.py:458-543)."""

    def __init__(self):
        self.numbers = EnglishNumberNormalizer()
        self.spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # <asides> and [asides]
        s = re.sub(r"\(([^)]+?)\)", "", s)        # (asides)
        s = re.sub(_FILLERS, "", s)
        s = re.sub(r"\s+'", "'", s)               # re-attach apostrophes

        for pattern, replacement in _REWRITES:
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)      # 1,000 -> 1000
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)    # keep only numeric periods
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.numbers(s)
        s = self.spellings(s)

        # drop numeric symbols that ended up with no digits around them
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        return re.sub(r"\s+", " ", s)
