"""Full-duplex cognition plane: ASR text + scene summaries → LLM → phrases →
avatar TTS (a copy of mere_fusion_tpu/brain/)."""

from mere_fusion_tpu_torch.brain.orchestrator import (  # noqa: F401
    PERSONA_PROMPT,
    BrainSession,
    split_phrases,
)
