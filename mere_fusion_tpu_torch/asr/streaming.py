"""Hypothesis stabilization and buffer management for streaming ASR.

A copy of mere_fusion_tpu/asr/streaming.py (host code).

Algorithmic parity with the reference (whisper_online.py:305-566):
- words commit when two consecutive hypotheses agree on a prefix (LCP);
- up-to-5-gram overlap between committed tail and new hypothesis head is
  dropped (repetition guard);
- the audio buffer grows until a trim threshold, then is cut at a completed
  segment or sentence boundary;
- a 200-char suffix of committed text that scrolled out of the buffer is
  passed to the model as prompt.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Word:
    beg: float
    end: float
    text: str

    def shifted(self, offset: float) -> "Word":
        return Word(
            self.beg + offset if self.beg is not None else offset,
            self.end + offset if self.end is not None else offset,
            self.text,
        )


def join_words(words: Sequence[Word], sep: str = " ") -> tuple[Optional[float], Optional[float], str]:
    """Collapse words to a (beg, end, text) emission tuple."""
    if not words:
        return (None, None, "")
    return (words[0].beg, words[-1].end, sep.join(w.text for w in words))


class HypothesisBuffer:
    """Commit-by-longest-common-prefix over consecutive hypotheses."""

    MAX_NGRAM = 5

    def __init__(self):
        self.committed_in_buffer: list[Word] = []
        self.buffer: list[Word] = []
        self.new: list[Word] = []
        self.last_committed_time = 0.0
        self.last_committed_word: Optional[str] = None

    def insert(self, words: Sequence[Word], offset: float) -> None:
        shifted = [w.shifted(offset) for w in words]
        self.new = [w for w in shifted if w.beg > self.last_committed_time - 0.1]
        if not self.new:
            return
        # n-gram repetition guard at the committed/new seam
        if abs(self.new[0].beg - self.last_committed_time) < 1 and self.committed_in_buffer:
            cn, nn = len(self.committed_in_buffer), len(self.new)
            for i in range(1, min(cn, nn, self.MAX_NGRAM) + 1):
                committed_tail = " ".join(
                    w.text for w in self.committed_in_buffer[-i:]
                )
                new_head = " ".join(w.text for w in self.new[:i])
                if committed_tail == new_head:
                    dropped = self.new[:i]
                    del self.new[:i]
                    logger.debug("dropped repeated %d-gram: %s", i, dropped)
                    break

    def flush(self) -> list[Word]:
        """Return the prefix agreed between the previous and new hypothesis."""
        commit: list[Word] = []
        while self.new and self.buffer:
            if self.new[0].text != self.buffer[0].text:
                break
            w = self.new.pop(0)
            self.buffer.pop(0)
            commit.append(w)
            self.last_committed_word = w.text
            self.last_committed_time = w.end
        self.buffer = self.new
        self.new = []
        self.committed_in_buffer.extend(commit)
        return commit

    def pop_committed(self, time: float) -> None:
        while self.committed_in_buffer and self.committed_in_buffer[0].end <= time:
            self.committed_in_buffer.pop(0)

    def complete(self) -> list[Word]:
        return self.buffer


class StreamingTranscriber:
    """Unbounded-audio streaming transcription over an ASR backend."""

    SAMPLING_RATE = 16000
    PROMPT_CHARS = 200

    def __init__(
        self,
        backend,
        tokenizer=None,
        buffer_trimming: tuple[str, float] = ("segment", 15.0),
    ):
        self.backend = backend
        self.trim_way, self.trim_sec = buffer_trimming
        if tokenizer is None and self.trim_way == "sentence":
            # sentence-mode trimming needs a sentence segmenter out of the
            # box (reference whisper_online.py:612-616 builds one via
            # create_tokenizer whenever --buffer_trimming sentence); default
            # to the backend's language (en when unknown/auto-undetected)
            from mere_fusion_tpu_torch.asr.sentences import create_tokenizer
            tokenizer = create_tokenizer(
                getattr(backend, "language", None))
        self.tokenizer = tokenizer
        self.init()

    def init(self) -> None:
        self.audio_buffer = np.array([], dtype=np.float32)
        self.buffer_time_offset = 0.0
        self.transcript_buffer = HypothesisBuffer()
        self.committed: list[Word] = []

    @property
    def buffer_seconds(self) -> float:
        return len(self.audio_buffer) / self.SAMPLING_RATE

    def insert_audio_chunk(self, audio: np.ndarray) -> None:
        self.audio_buffer = np.append(self.audio_buffer, audio)

    def prompt(self) -> tuple[str, str]:
        """(prompt, context): prompt = ≤200-char committed suffix that
        scrolled out of the buffer; context = committed text still inside."""
        k = max(0, len(self.committed) - 1)
        while k > 0 and self.committed[k - 1].end > self.buffer_time_offset:
            k -= 1
        scrolled = [w.text for w in self.committed[:k]]
        prompt: list[str] = []
        length = 0
        while scrolled and length < self.PROMPT_CHARS:
            x = scrolled.pop()
            length += len(x) + 1
            prompt.append(x)
        sep = self.backend.sep
        context = sep.join(w.text for w in self.committed[k:])
        return sep.join(reversed(prompt)), context

    def process_iter(self):
        """Transcribe the current buffer; return newly committed (b, e, text)."""
        prompt, _context = self.prompt()
        res = self.backend.transcribe(self.audio_buffer, init_prompt=prompt)
        words = self.backend.ts_words(res)
        self.transcript_buffer.insert(words, self.buffer_time_offset)
        committed_now = self.transcript_buffer.flush()
        self.committed.extend(committed_now)

        if committed_now and self.trim_way == "sentence":
            if self.buffer_seconds > self.trim_sec:
                self._trim_completed_sentence()

        seg_threshold = self.trim_sec if self.trim_way == "segment" else 30.0
        if self.buffer_seconds > seg_threshold:
            self._trim_completed_segment(res)

        return join_words(committed_now, self.backend.sep)

    def finish(self):
        """Flush the uncommitted tail at end of stream."""
        tail = self.transcript_buffer.complete()
        return join_words(tail, self.backend.sep)

    # ---- trimming -----------------------------------------------------------
    def _trim_at(self, time: float) -> None:
        self.transcript_buffer.pop_committed(time)
        cut = time - self.buffer_time_offset
        self.audio_buffer = self.audio_buffer[int(cut * self.SAMPLING_RATE):]
        self.buffer_time_offset = time

    def _trim_completed_sentence(self) -> None:
        if not self.committed:
            return
        sents = self._words_to_sentences(self.committed)
        if len(sents) < 2:
            return
        # keep the last two sentences in the buffer
        self._trim_at(sents[-2][1])

    def _trim_completed_segment(self, res) -> None:
        if not self.committed:
            return
        ends = list(self.backend.segments_end_ts(res))
        t = self.committed[-1].end
        if len(ends) > 1:
            e = ends[-2] + self.buffer_time_offset
            while len(ends) > 2 and e > t:
                ends.pop()
                e = ends[-2] + self.buffer_time_offset
            if e <= t:
                self._trim_at(e)

    def _words_to_sentences(self, words: Sequence[Word]):
        """Sentence segmentation via the optional tokenizer (split method)."""
        text = " ".join(w.text for w in words)
        sents = self.tokenizer.split(text) if self.tokenizer else [text]
        cwords = list(words)
        out = []
        for sent in sents:
            sent = sent.strip()
            fsent = sent
            beg = end = None
            while cwords:
                w = cwords.pop(0)
                wt = w.text.strip()
                if beg is None and sent.startswith(wt):
                    beg = w.beg
                    if sent == wt:
                        # single-word sentence: the reference's matcher
                        # (whisper_online.py:544-556) never closes this
                        # case and silently drains the remaining words —
                        # common in zh, where one ASR word is a whole
                        # sentence, so close it here
                        out.append((beg, w.end, fsent))
                        break
                elif end is None and sent == wt:
                    end = w.end
                    out.append((beg, end, fsent))
                    break
                sent = sent[len(wt):].strip()
        return out
