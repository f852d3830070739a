"""Media transport: frame types and paced output tracks."""

from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage  # noqa: F401
from mere_fusion_tpu_torch.transport.tracks import (  # noqa: F401
    HumanPlayer,
    PlayerStreamTrack,
)
