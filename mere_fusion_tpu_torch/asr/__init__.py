"""Streaming ASR: hypothesis stabilization + unbounded-audio transcription.

Port of mere_fusion_tpu/asr/: the host-side logic of the reference's
whisper_online.py (the LCP-commit HypothesisBuffer, the growing audio buffer
with prompt carry-over and segment/sentence trimming) over a typed backend
protocol, the energy VAD, the DTW word aligner, and the backends: the port's
Whisper on the card (``TorchWhisperBackend``, with the offline long-file
path ``transcribe_long``), faster-whisper, the OpenAI API and a scripted
fake. Beside them: the transcript normalizers, the txt/vtt/srt writers, the
streaming simulation (``simulate.py``), the socket server (``server.py``)
and the CLI, ``python -m mere_fusion_tpu_torch.asr``.
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
from mere_fusion_tpu_torch.asr.normalizers import (  # noqa: F401
    BasicTextNormalizer,
    EnglishTextNormalizer,
)
from mere_fusion_tpu_torch.asr.numwords import EnglishNumberNormalizer  # noqa: F401
from mere_fusion_tpu_torch.asr.spelling import EnglishSpellingNormalizer  # noqa: F401
