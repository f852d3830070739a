"""Media transport: frame types, paced output tracks, and the live legs
out of a session: rtp (`rtp`, `rtp_send`), RTMP (`rtmp`, `rtmp_native`,
`flv`) and the ELITR line protocol (`line_packet`)."""

from mere_fusion_tpu_torch.transport.frames import AudioChunk, VideoImage  # noqa: F401
from mere_fusion_tpu_torch.transport.tracks import (  # noqa: F401
    HumanPlayer,
    PlayerStreamTrack,
)
