"""Sentence segmentation for sentence-mode buffer trimming.

A copy of mere_fusion_tpu/asr/sentences.py.

The reference's ``create_tokenizer`` (whisper_online.py:573-604) returns a
Moses/WtP/uk tokenizer object with a ``split(text) -> list[str]`` method and
is REQUIRED for ``--buffer_trimming sentence``. None of those packages is a
dependency of this project, so this module keeps the same factory contract
with a dependency-free rule splitter as the default (sentence trimming only
needs *completed-sentence boundaries*, not linguistic
perfection; a missed boundary merely delays a trim by one sentence).

``create_tokenizer(lan)`` prefers the reference's exact tokenizers when the
optional packages happen to be importable (mosestokenizer for the Moses
language list, tokenize_uk for uk, wtpsplit otherwise) and falls back to
``RuleSentenceSplitter`` — terminal-punctuation rules with an abbreviation
table for Latin scripts plus CJK full-width terminal marks, covering at
minimum en and zh out of the box.
"""
from __future__ import annotations

import re

# English/Latin abbreviations that end with "." but do not end a sentence
# (a compact version of Moses' nonbreaking_prefixes/nonbreaking_prefix.en).
_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "hon", "st", "sr", "jr",
    "gen", "rep", "sen", "gov", "lt", "maj", "col", "sgt", "capt", "cmdr",
    "vs", "etc", "eg", "e.g", "ie", "i.e", "cf", "al", "approx", "dept",
    "est", "fig", "inc", "ltd", "co", "corp", "no", "nos", "vol", "p",
    "pp", "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept",
    "oct", "nov", "dec", "mon", "tue", "wed", "thu", "fri", "sat", "sun",
    "u.s", "u.k", "u.n", "a.m", "p.m",
}

#: CJK sentence-terminal marks (split AFTER these, no whitespace needed);
#: trailing closing quotes/brackets stay attached to the finished sentence.
_CJK_TERMINALS = "。！？；…"
_CJK_CLOSERS = "」』”’）〉》】"

_LATIN_TERMINAL = re.compile(r"[.!?…]+[\"'”’)\]]*$")


def _is_abbreviation(token: str) -> bool:
    """token INCLUDES its trailing period(s)."""
    core = token.rstrip(".").lstrip("\"'“‘([").lower()
    if not core:
        return False
    if core in _ABBREV:
        return True
    # single-letter initial ("J." in "J. K. Rowling") or dotted acronym
    if len(core) == 1 and core.isalpha():
        return True
    if re.fullmatch(r"(?:[a-z]\.)+[a-z]?", core):
        return True
    # decimal / versions ("3.14", "v2.") never end a sentence mid-number
    if re.fullmatch(r"\d+(?:\.\d+)*", core):
        return True
    return False


class RuleSentenceSplitter:
    """``split(text) -> list[str]``, the ``create_tokenizer`` contract.

    Whitespace-tokenized scan for Latin scripts: a sentence ends at a token
    with terminal punctuation unless the token is a known abbreviation,
    initial, or number — and, for a bare ".", only if the next token starts
    a new sentence (uppercase/digit/quote) or the text ends. CJK terminal
    marks split in-token (no surrounding whitespace in zh/ja text)."""

    def __init__(self, lan: str | None = None):
        self.lan = (lan or "en").split("-")[0].lower()

    # -- CJK ---------------------------------------------------------------
    @staticmethod
    def _split_cjk(text: str) -> list[str]:
        out, cur = [], []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            cur.append(ch)
            if ch in _CJK_TERMINALS:
                # absorb repeated terminals ("？！") and closing quotes
                while i + 1 < n and text[i + 1] in _CJK_TERMINALS + _CJK_CLOSERS:
                    i += 1
                    cur.append(text[i])
                sent = "".join(cur).strip()
                if sent:
                    out.append(sent)
                cur = []
            i += 1
        tail = "".join(cur).strip()
        if tail:
            out.append(tail)
        return out

    # -- Latin -------------------------------------------------------------
    @classmethod
    def _split_latin(cls, text: str) -> list[str]:
        tokens = text.split()
        out, cur = [], []
        for i, tok in enumerate(tokens):
            cur.append(tok)
            if not _LATIN_TERMINAL.search(tok):
                continue
            stripped = tok.rstrip("\"'”’)]")
            if stripped.endswith(".") and not stripped.endswith(
                    ("...", "..", "!", "?")):
                if _is_abbreviation(stripped):
                    continue
                nxt = tokens[i + 1] if i + 1 < len(tokens) else None
                if nxt is not None and not (
                        nxt[0].isupper() or nxt[0].isdigit()
                        or nxt[0] in "\"'“‘(["):
                    continue
            out.append(" ".join(cur))
            cur = []
        if cur:
            out.append(" ".join(cur))
        return out

    def split(self, text: str) -> list[str]:
        text = text.strip()
        if not text:
            return []
        # route by content, not config: mixed transcripts (zh with Latin
        # loanwords, auto-detected language) segment on whichever terminal
        # marks actually appear
        if any(ch in _CJK_TERMINALS for ch in text):
            parts = []
            for seg in self._split_cjk(text):
                if any(ch in ".!?" for ch in seg) and " " in seg:
                    parts.extend(self._split_latin(seg))
                else:
                    parts.append(seg)
            return parts
        return self._split_latin(text)


#: the reference's fast-mosestokenizer language list (whisper_online.py:587)
_MOSES_LANGS = frozenset(
    "as bn ca cs de el en es et fi fr ga gu hi hu is it kn lt lv ml mni mr "
    "nl or pa pl pt ro ru sk sl sv ta te yue zh".split())


def create_tokenizer(lan: str | None):
    """Sentence tokenizer for language ``lan`` (reference
    whisper_online.py:573-604 contract: an object with .split(text)).

    Uses the reference's exact tokenizer when its package is importable;
    otherwise the dependency-free rule splitter — never raises for a
    missing optional dependency."""
    lan = (lan or "en").split("-")[0].lower()
    try:
        if lan == "uk":
            import tokenize_uk  # noqa: F401

            class _Uk:
                def split(self, text):
                    return tokenize_uk.tokenize_sents(text)

            return _Uk()
        if lan in _MOSES_LANGS:
            from mosestokenizer import MosesTokenizer
            return MosesTokenizer(lan)
        from wtpsplit import WtP
        wtp = WtP("wtp-canine-s-12l-no-adapters")

        class _WtP:
            def split(self, text):
                return wtp.split(text, lang_code=lan)

        return _WtP()
    except ImportError:
        return RuleSentenceSplitter(lan)
