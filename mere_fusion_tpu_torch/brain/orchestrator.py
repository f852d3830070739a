"""Per-session LLM orchestration.

A copy of mere_fusion_tpu/brain/orchestrator.py.

Behavioral twin of the reference's OpenAISessionManager
(reference: stream_openai_video.py:44-203): a phrase-generator thread merges
the latest ASR text with the latest scene summary into a persona prompt,
streams the LLM completion, splits it into speakable phrases (delimiter
search past a minimum length), and hands each phrase to the avatar engine's
TTS (``put_msg_txt``). Differences by design: phrases go through the
engine's own TTS adapters instead of pushing raw OpenAI-TTS PCM bytes into
the text queue, and thread shutdown is a plain Event without the reference's
finally-close bug.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Iterable, Iterator

logger = logging.getLogger(__name__)

DELIMITERS = tuple(f"{d} " for d in (".", "?", "!")) + ("。", "？", "！")
MINIMUM_PHRASE_LENGTH = 200

PERSONA_PROMPT = (
    "You are playing a human in a live video call. Treat the text as what "
    "the caller said and the scene description as what you can see. Respond "
    "naturally and conversationally; your output will be spoken aloud, so "
    "produce plain speakable sentences only."
)


def split_phrases(
    chunks: Iterable[str],
    min_len: int = MINIMUM_PHRASE_LENGTH,
    delimiters: tuple = DELIMITERS,
) -> Iterator[str]:
    """Split a token stream into speakable phrases.

    A phrase ends at the earliest delimiter found at or after min_len
    (stream_openai_video.py:101-121); the remainder is flushed at the end.
    """
    working = ""
    for content in chunks:
        working += content.replace("\n", " ")
        while len(working) >= min_len:
            cut = -1
            for d in delimiters:
                i = working.find(d, min_len)
                if i != -1 and (cut == -1 or i < cut):
                    cut = i + len(d)
            if cut == -1:
                break
            phrase, working = working[:cut], working[cut:]
            if phrase.strip():
                yield phrase.strip()
    if working.strip():
        yield working.strip()


class BrainSession:
    """Threads: text+video queues → LLM stream → phrases → engine TTS."""

    def __init__(self, engine, llm, min_phrase_len: int = MINIMUM_PHRASE_LENGTH):
        self.engine = engine
        self.llm = llm
        self.min_phrase_len = min_phrase_len
        self.text_in_queue: queue.Queue = queue.Queue()
        self.video_in_queue: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self._thread = threading.Thread(target=self._phrase_loop, daemon=True)
        self._thread.start()

    # upstream producers (ASR / video understanding)
    def text_produce(self, text: str) -> None:
        self.text_in_queue.put(text)

    def video_produce(self, summary: str) -> None:
        self.video_in_queue.put(summary)

    def _latest_video_summary(self) -> str:
        summary = "no scene information available"
        while not self.video_in_queue.empty():
            summary = self.video_in_queue.get()
        return summary

    def _phrase_loop(self) -> None:
        while not self.stop_event.is_set():
            try:
                text = self.text_in_queue.get(timeout=1)
            except queue.Empty:
                continue
            if text is None:
                return
            scene = self._latest_video_summary()
            messages = [
                {"role": "system", "content": PERSONA_PROMPT},
                {"role": "user", "content": f"text: {text}\nscene: {scene}"},
            ]
            try:
                for phrase in split_phrases(
                    self.llm.stream_chat(messages), self.min_phrase_len
                ):
                    if self.stop_event.is_set():
                        break
                    logger.info("brain phrase: %s", phrase)
                    self.engine.put_msg_txt(phrase)
            except Exception as e:
                logger.error("brain llm error: %s", e)

    def interrupt(self) -> None:
        """Barge-in: drop pending text and silence the avatar."""
        with self.text_in_queue.mutex:
            self.text_in_queue.queue.clear()
        self.engine.pause_talk()

    def close(self) -> None:
        self.stop_event.set()
        self.text_in_queue.put(None)
        self._thread.join(timeout=5)
