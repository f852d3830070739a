"""Spelled-out-number -> digit rewriting for English transcripts.

Port of mere_fusion_tpu/asr/numwords.py: plain Python, copied.

Behavioral re-implementation of the reference's EnglishNumberNormalizer
(reference: musetalk/whisper/whisper/normalizers/english.py:12-440), used
inside the full English transcript normalizer.  The contract (including
the reference's quirks, which the parity test pins):

- "one hundred and one" -> "101"; "and" is swallowed only right after a
  multiplier word.
- successive single digits are nominal: "one oh one" -> "101";
  "double seven" -> "77"; "point five" -> ".5".
- plural/ordinal forms keep their suffix: "thirty-second" -> "32nd",
  "1960s" stays, "sixties" -> "60s".
- sign and currency words become symbols: "minus three" -> "-3",
  "twenty dollars" -> "$20", "per cent"/"percent" -> "%".
- "<n> dollars <m> cents" is fused to "$n.mm" in postprocessing; a bare
  "$0.xx" becomes "¢xx"; a bare "1"/"1s" is written back as "one"/"ones".
- "<decimal> and a half" -> "<decimal> point five"; a leading "and a
  half" with nothing before it is dropped (reference preprocess quirk).

The implementation is an explicit cursor scan with a small accumulator
(int for arithmetic composition, digit-string once positional writing
starts) rather than the reference's windowed-generator; the parity test
fuzzes both over the full vocabulary (tests/test_normalizers.py).
"""
from __future__ import annotations

import re
from fractions import Fraction
from typing import List, Optional, Union

_NUMERAL = re.compile(r"^\d+(\.\d+)?$")

_ZEROS = {"o", "oh", "zero"}

_ONES_ORDER = ["one", "two", "three", "four", "five", "six", "seven",
               "eight", "nine", "ten", "eleven", "twelve", "thirteen",
               "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
               "nineteen"]
_ONES = {w: i + 1 for i, w in enumerate(_ONES_ORDER)}

_IRREGULAR_ORDINALS = {"zeroth": (0, "th"), "first": (1, "st"),
                       "second": (2, "nd"), "third": (3, "rd"),
                       "fifth": (5, "th"), "twelfth": (12, "th")}


def _ones_suffixed() -> dict:
    table = dict(_IRREGULAR_ORDINALS)
    for w, v in _ONES.items():
        # plural: "sixes", otherwise word+s
        table["sixes" if w == "six" else w + "s"] = (v, "s")
        if v > 3 and v not in (5, 12):
            # regular ordinal: "eighth" keeps the single t
            table[w + ("h" if w.endswith("t") else "th")] = (v, "th")
    return table


_ONES_SUFFIXED = _ones_suffixed()

_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
         "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
_TENS_SUFFIXED = {}
for _w, _v in _TENS.items():
    _TENS_SUFFIXED[_w[:-1] + "ies"] = (_v, "s")     # sixties -> 60s
    _TENS_SUFFIXED[_w[:-1] + "ieth"] = (_v, "th")   # sixtieth -> 60th

_MULTIPLIERS = {"hundred": 10 ** 2, "thousand": 10 ** 3,
                "million": 10 ** 6, "billion": 10 ** 9,
                "trillion": 10 ** 12, "quadrillion": 10 ** 15,
                "quintillion": 10 ** 18, "sextillion": 10 ** 21,
                "septillion": 10 ** 24, "octillion": 10 ** 27,
                "nonillion": 10 ** 30, "decillion": 10 ** 33}
_MULTIPLIERS_SUFFIXED = {}
for _w, _v in _MULTIPLIERS.items():
    _MULTIPLIERS_SUFFIXED[_w + "s"] = (_v, "s")
    _MULTIPLIERS_SUFFIXED[_w + "th"] = (_v, "th")

_SIGN_WORDS = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
_CURRENCY_WORDS = {"pound": "£", "pounds": "£", "euro": "€", "euros": "€",
                   "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢"}
_PREFIX_SYMBOLS = set(_SIGN_WORDS.values()) | set(_CURRENCY_WORDS.values())
_PERCENT_WORDS = {"percent"}          # "per cent" handled via lookahead
_SPECIALS = {"and", "double", "triple", "point"}
_DECIMAL_WORDS = set(_ONES) | set(_TENS) | _ZEROS

_VOCAB = (_ZEROS | set(_ONES) | set(_ONES_SUFFIXED) | set(_TENS)
          | set(_TENS_SUFFIXED) | set(_MULTIPLIERS)
          | set(_MULTIPLIERS_SUFFIXED) | set(_SIGN_WORDS)
          | set(_CURRENCY_WORDS) | _PERCENT_WORDS | {"per"} | _SPECIALS)

Acc = Optional[Union[int, str]]


class EnglishNumberNormalizer:
    """Rewrite spelled-out numbers to digits (see module docstring)."""

    def __call__(self, s: str) -> str:
        s = self._pre(s)
        s = " ".join(self._scan(s.split()))
        return self._post(s)

    # -- pre/post passes ---------------------------------------------------

    def _pre(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        parts = re.split(r"\band\s+a\s+half\b", s)
        kept: List[str] = []
        for i, part in enumerate(parts):
            if not part.strip():
                continue  # a leading/duplicated split: the phrase is dropped
            kept.append(part)
            if i != len(parts) - 1:
                tail = part.rsplit(maxsplit=2)[-1]
                if tail in _DECIMAL_WORDS or tail in _MULTIPLIERS:
                    kept.append("point five")
                else:
                    kept.append("and a half")
        s = " ".join(kept)
        # split letter/digit boundaries, then re-attach ordinal/plural
        # suffixes that the split just detached ("32 nd" -> "32nd")
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def _post(self, s: str) -> str:
        # "$2 and ¢7" / "$2 ¢7" -> "$2.07"
        s = re.sub(
            r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b",
            lambda m: f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}", s)
        # "$0.xx" -> "¢xx" (the unescaped dot matches the reference regex)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b",
                   lambda m: f"¢{int(m.group(1))}", s)
        # bare "1"/"1s" reads better spelled out
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    # -- the token scan ----------------------------------------------------

    def _scan(self, words: List[str]):
        acc: Acc = None           # int while arithmetic, str once positional
        prefix: Optional[str] = None
        skip_next = False
        out: List[str] = []

        def emit(result: Union[int, str]):
            nonlocal acc, prefix
            text = str(result)
            if prefix is not None:
                text = prefix + text
            acc = None
            prefix = None
            out.append(text)

        def flush():
            if acc is not None:
                emit(acc)

        n = len(words)
        for i, cur in enumerate(words):
            if skip_next:
                skip_next = False
                continue
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i + 1 < n else None
            nxt_numeric = nxt is not None and _NUMERAL.match(nxt)

            symbol = cur[0] if cur[:1] in _PREFIX_SYMBOLS else None
            bare = cur[1:] if symbol else cur

            if _NUMERAL.match(bare):
                if isinstance(acc, str) and acc.endswith("."):
                    # decimal tail / dotted-quad continuation: the raw
                    # token (symbol included) concatenates — ref quirk
                    acc = acc + cur
                    continue
                flush()
                if symbol:
                    prefix = symbol
                frac = Fraction(bare)
                acc = frac.numerator if frac.denominator == 1 else bare

            elif cur not in _VOCAB:
                flush()
                emit(cur)

            elif cur in _ZEROS:
                # `acc or ""` drops a falsy accumulator (bare int 0) — a
                # reference quirk the parity test pins: "0 point five" -> ".5"
                acc = str(acc or "") + "0"

            elif cur in _ONES:
                acc = self._add_ones(acc, prev, _ONES[cur])

            elif cur in _ONES_SUFFIXED:
                value, suffix = _ONES_SUFFIXED[cur]
                merged = self._add_ones(acc, prev, value)
                emit(str(merged) + suffix)

            elif cur in _TENS:
                acc = self._add_tens(acc, _TENS[cur])

            elif cur in _TENS_SUFFIXED:
                value, suffix = _TENS_SUFFIXED[cur]
                emit(str(self._add_tens(acc, value)) + suffix)

            elif cur in _MULTIPLIERS:
                mult = _MULTIPLIERS[cur]
                if acc is None:
                    acc = mult
                elif isinstance(acc, str) or acc == 0:
                    product = self._times(acc, mult)
                    if product is not None:
                        acc = product
                    else:
                        flush()
                        acc = mult
                else:
                    acc = self._scale(acc, mult)

            elif cur in _MULTIPLIERS_SUFFIXED:
                mult, suffix = _MULTIPLIERS_SUFFIXED[cur]
                if acc is None:
                    emit(str(mult) + suffix)
                elif isinstance(acc, str):
                    product = self._times(acc, mult)
                    if product is not None:
                        emit(str(product) + suffix)
                    else:
                        flush()
                        emit(str(mult) + suffix)
                else:
                    emit(str(self._scale(acc, mult)) + suffix)
                acc = None

            elif cur in _SIGN_WORDS:
                flush()
                if (nxt in _VOCAB) or nxt_numeric:
                    prefix = _SIGN_WORDS[cur]
                else:
                    emit(cur)

            elif cur in _CURRENCY_WORDS:
                if acc is not None:
                    prefix = _CURRENCY_WORDS[cur]
                    flush()
                else:
                    emit(cur)

            elif cur in _PERCENT_WORDS:
                if acc is not None:
                    emit(str(acc) + "%")
                else:
                    emit(cur)

            elif cur == "per":
                if acc is not None:
                    if nxt == "cent":
                        emit(str(acc) + "%")
                        skip_next = True
                    else:
                        flush()
                        emit(cur)
                else:
                    emit(cur)

            else:  # the specials: and / double / triple / point
                if nxt not in _VOCAB and not nxt_numeric:
                    flush()
                    emit(cur)
                elif cur == "and":
                    if prev not in _MULTIPLIERS:  # "hundred and one" glue
                        flush()
                        emit(cur)
                elif cur in ("double", "triple"):
                    if nxt in _ONES or nxt in _ZEROS:
                        repeats = 2 if cur == "double" else 3
                        digit = str(_ONES.get(nxt, 0))
                        acc = str(acc or "") + digit * repeats
                        skip_next = True
                    else:
                        flush()
                        emit(cur)
                elif cur == "point":
                    if nxt in _DECIMAL_WORDS or nxt_numeric:
                        acc = str(acc or "") + "."

        flush()
        return out

    # -- accumulator composition (the reference's case analysis) ----------

    @staticmethod
    def _add_ones(acc: Acc, prev: Optional[str], value: int) -> Acc:
        """Fold a 1..19 word into the accumulator."""
        if acc is None:
            return value
        if isinstance(acc, str) or prev in _ONES:
            if prev in _TENS and value < 10:
                # "twenty one": the trailing 0 becomes the digit
                return str(acc)[:-1] + str(value)
            return str(acc) + str(value)           # nominal: "one one"
        if value < 10:
            return acc + value if acc % 10 == 0 else str(acc) + str(value)
        # eleven..nineteen compose only onto whole hundreds
        return acc + value if acc % 100 == 0 else str(acc) + str(value)

    @staticmethod
    def _add_tens(acc: Acc, value: int) -> Acc:
        if acc is None:
            return value
        if isinstance(acc, str):
            return str(acc) + str(value)
        return acc + value if acc % 100 == 0 else str(acc) + str(value)

    @staticmethod
    def _times(acc: Union[int, str], mult: int) -> Optional[int]:
        """Multiply a decimal-string (or zero) accumulator; None if the
        product is not integral or the string is not a number."""
        try:
            frac = Fraction(acc)
        except ValueError:
            return None
        product = frac * mult
        return product.numerator if product.denominator == 1 else None

    @staticmethod
    def _scale(acc: int, mult: int) -> int:
        """Apply a multiplier to the sub-thousand segment: the already
        completed thousands ride along ("two thousand three hundred")."""
        return acc // 1000 * 1000 + (acc % 1000) * mult
