"""Device compute primitives: DSP front-ends and the hand-written kernels."""

from mere_fusion_tpu_torch.ops.mel import (  # noqa: F401
    MelConfig,
    WAV2LIP_MEL,
    WHISPER_MEL,
    WHISPER_MEL_128,
    whisper_mel_config,
    mel_filterbank,
    melspectrogram,
)
