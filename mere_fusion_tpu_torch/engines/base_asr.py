"""Audio-frame → feature-queue plumbing shared by all avatar engines.

Behavioral twin of the reference's BaseASR (baseasr.py:9-64): a host queue of
20 ms chunks, silence synthesis when upstream is quiet (type 0 = speech,
1 = silence, >=2 = custom idle track), stride-based warm-up, and a bounded
feature queue to the device inference stage. The reference's mp.Queue
cross-process channel becomes a plain bounded Queue — inference runs
in-process as async device dispatches, so frames are never pickled.
"""
from __future__ import annotations

import queue
from queue import Queue

import numpy as np

from mere_fusion_tpu_torch.config import Config


class BaseASR:
    def __init__(self, cfg: Config, parent=None):
        self.cfg = cfg
        self.parent = parent
        self.fps = cfg.audio.fps
        self.sample_rate = cfg.audio.sample_rate
        self.chunk = cfg.audio.chunk
        self.queue: Queue[np.ndarray] = Queue()
        self.output_queue: Queue = Queue()
        self.batch_size = cfg.avatar.batch_size
        self.frames: list[np.ndarray] = []
        self.stride_left_size = cfg.stride.left
        self.stride_right_size = cfg.stride.right
        self.feat_queue: Queue = Queue(2)
        # set on the first speech chunk after silence; engines clear it when
        # the first generated frame ships (audio-to-first-frame latency)
        self.speech_start_ts = None
        self._in_speech = False
        # Sequence numbers for silence skipping: consumed_seq counts chunks
        # pulled by the featurizer; skip_before_seq marks the consumption
        # point at which real speech entered the queue. Any SILENCE entry
        # consumed before that point is stale pre-buffered idle output that
        # would otherwise pace-delay the first speech frame by the whole
        # pipeline depth (~1.6 s at batch 16) — engines drop those entries
        # instead of playing them, collapsing audio-to-first-frame latency
        # to track-queue depth + one batch compute.
        self.consumed_seq = 0
        self.skip_before_seq = 0

    def pause_talk(self) -> None:
        self.queue.queue.clear()

    def put_audio_frame(self, audio_chunk: np.ndarray) -> None:
        import time

        if not self._in_speech:
            # arm only on the silence→speech transition — chunks arriving
            # mid-utterance (the TTS streams continuously) must NOT re-arm
            # after the engine observed and cleared the first-frame latency,
            # or the metric fills with ~0 ms mid-utterance samples
            self._in_speech = True
            if self.speech_start_ts is None:
                self.speech_start_ts = time.monotonic()
        # everything consumed so far but not yet played is stale silence
        self.skip_before_seq = self.consumed_seq + 1
        self.queue.put(audio_chunk)

    # how long get_audio_frame waits for live speech before synthesizing
    # silence; None = non-blocking (NerfASR polls at frame rate and must
    # never stall the render loop)
    queue_timeout: float | None = 0.01
    # consecutive empty polls (20 ms chunks apiece) before the utterance is
    # considered over and the next put arms a fresh speech clock. A single
    # empty poll is routinely just the consumer bursting one chunk ahead of a
    # real-time TTS stream — clearing on it would re-arm mid-utterance and
    # fill the first-frame metric with tiny bogus samples. 10 chunks = 200 ms
    # of genuine silence.
    silence_rearm_chunks: int = 10
    _silence_run: int = 0

    def get_audio_frame(self) -> tuple[np.ndarray, int]:
        self.consumed_seq += 1
        try:
            if self.queue_timeout is None:
                frame = self.queue.get(block=False)
            else:
                frame = self.queue.get(block=True, timeout=self.queue_timeout)
            ftype = 0
            self._silence_run = 0
        except queue.Empty:
            self._silence_run += 1
            if self._silence_run >= self.silence_rearm_chunks:
                self._in_speech = False  # drained: next put starts an utterance
            if self.parent and self.parent.curr_state > 1:
                frame = self.parent.get_audio_stream(self.parent.curr_state)
                ftype = self.parent.curr_state
            else:
                frame = np.zeros(self.chunk, dtype=np.float32)
                ftype = 1
        return frame, ftype

    def get_audio_out(self):
        return self.output_queue.get()

    def is_stale_silence(self, audio_frames) -> bool:
        """True when every (frame, ftype, seq) entry is non-speech consumed
        before the newest speech arrival — i.e. pre-buffered idle output that
        should be dropped, not played, so queued speech ships sooner."""
        return all(f[1] != 0 and f[2] < self.skip_before_seq
                   for f in audio_frames)

    def warm_up(self) -> None:
        for _ in range(self.stride_left_size + self.stride_right_size):
            frame, ftype = self.get_audio_frame()
            self.frames.append(frame)
            self.output_queue.put((frame, ftype, self.consumed_seq))
        for _ in range(self.stride_left_size):
            self.output_queue.get()

    def run_step(self) -> None:
        raise NotImplementedError

    def get_next_feat(self, block: bool = True, timeout: float | None = None):
        return self.feat_queue.get(block, timeout)
