"""Streaming ASR: hypothesis stabilization + unbounded-audio transcription.

Port of mere_fusion_tpu/asr/: the host-side logic of the reference's
whisper_online.py (the LCP-commit HypothesisBuffer, the growing audio buffer
with prompt carry-over and segment/sentence trimming) over a typed backend
protocol, the energy VAD, the DTW word aligner, and the backends: the port's
Whisper on the card (``TorchWhisperBackend``), faster-whisper, the OpenAI
API and a scripted fake. The text normalizers, the writers, the simulation
and server entry points and the offline long-file path are not ported yet
(ROADMAP: 'Streaming ASR, the rest').
"""

from mere_fusion_tpu_torch.asr.streaming import (  # noqa: F401
    HypothesisBuffer,
    StreamingTranscriber,
    Word,
)
from mere_fusion_tpu_torch.asr.backends import (  # noqa: F401
    ASRBackend,
    FakeBackend,
    FasterWhisperBackend,
    OpenAIApiBackend,
    TorchWhisperBackend,
    make_backend,
    timestamp_segments,
)
from mere_fusion_tpu_torch.asr.vad import filter_words, has_speech, speech_segments  # noqa: F401
